"""The A^T B launcher's choice of kernel, tile and staging, on the CPU.

`kernel.plan` states in Python what the C entry point picks
(`make_plan` in csrc/tiled_matmul.cu); on the card chip_smoke.py holds the
two equal for every shape it runs.  Here: bf16 always takes the tensor
cores and fp32 the CUDA cores; every size of the METG ladder fills the
card (a grid of at least 132 blocks) or splits k inside its blocks; and
each shape's staging is one its alignment allows (16-byte copies need
every row start 16-byte aligned, 4-byte copies every row start 4-byte
aligned)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.tiled_matmul import kernel  # noqa: E402
from repro_torch.launch.metg import SIZES  # noqa: E402

RAGGED = [(1000, 130, 70), (1, 1, 1), (17, 65, 63), (0, 5, 3), (33, 200, 1)]
SQUARES = [(n, n, n) for n in SIZES]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("n", SIZES)
def test_ladder_sizes_fill_the_card(n):
    p = kernel.plan(torch.float32, n, n, n)
    assert p.route == 0
    assert p.blocks >= kernel.MIN_BLOCKS or p.ksplit > 1, p
    assert p.blocks == -(-n // p.bm) * -(-n // p.bn)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,M,N", SQUARES + RAGGED)
def test_route_follows_the_type(dtype, K, M, N):
    p = kernel.plan(dtype, K, M, N)
    want = "bf16 tensor cores" if dtype == torch.bfloat16 else "fp32 CUDA"
    assert kernel.ROUTES[p.route].startswith(want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,M,N", RAGGED + SQUARES)
def test_staging_is_one_the_alignment_allows(dtype, K, M, N):
    item = 4 if dtype == torch.float32 else 2
    per16 = 16 // item
    p = kernel.plan(dtype, K, M, N)
    staging = kernel.STAGINGS[p.staging]
    if staging == "cp.async 16 B":
        assert M % per16 == 0 and N % per16 == 0
    elif staging == "cp.async 4 B":
        # one fp32, or a bf16 pair, and every row start 4-byte aligned
        assert dtype == torch.float32 or (M % 2 == 0 and N % 2 == 0)
    else:
        # 2-byte elements on rows that start 2-byte aligned
        assert dtype == torch.bfloat16 and (M % 2 or N % 2)
    # the widest copy the rows allow is taken
    if M % per16 == 0 and N % per16 == 0:
        assert staging == "cp.async 16 B"
    elif M % 2 == 0 and N % 2 == 0:
        assert staging == "cp.async 4 B"


@pytest.mark.parametrize("dtype", DTYPES)
def test_misaligned_base_gives_up_16_byte_copies(dtype):
    item = 4 if dtype == torch.float32 else 2
    assert kernel.STAGINGS[kernel.plan(dtype, 64, 256, 256).staging] \
        == "cp.async 16 B"
    p = kernel.plan(dtype, 64, 256, 256, a_ptr=item)
    assert kernel.STAGINGS[p.staging] != "cp.async 16 B"


def test_tile_shrinks_only_while_the_grid_is_short():
    """The largest fp32 tile whose grid reaches MIN_BLOCKS is taken."""
    big = kernel.plan(torch.float32, 64, 4096, 4096)
    assert (big.bm, big.bn, big.ksplit) == kernel.F32_CONFIGS[0][:2] + (1,)
    for M, N in [(1024, 1024), (512, 512), (130, 70)]:
        p = kernel.plan(torch.float32, 64, M, N)
        larger = [c for c in kernel.F32_CONFIGS if c[0] > p.bm]
        assert all(-(-M // c[0]) * -(-N // c[1]) < kernel.MIN_BLOCKS
                   for c in larger)
