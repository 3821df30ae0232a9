"""The port's checkpoints against the JAX package's `checkpoint/ckpt.py`,
on a {"params", "opt"} tree: reduced gemma2-2b's params from JAX's init
and an AdamW state with moments in float32 or bfloat16, through the bridge.

- The same tree gives JAX's manifest (keys, shapes, dtypes, metadata; the
  treedef string, which nothing reads, and the time apart) and the same
  `arrays.npz` bytes.
- Round trips are bit for bit: port -> port (bf16 leaves too), JAX -> port
  (fp32 and bf16; the port reads JAX's raw `<V2` bf16 words through the
  manifest's dtype), port -> JAX (fp32: JAX's own restore cannot cast its
  `<V2` bf16 leaves back, ROADMAP Queue 3).
- `AsyncCheckpointer` keeps `keep` steps, and a save followed at once by
  an in-place update of the tree (the port's train step updates in place)
  restores the state from before the update."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import ckpt as jax_ckpt  # noqa: E402
from repro.configs import RunConfig as JaxRunConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

STATE_DTYPES = ["float32", "bfloat16"]


def _jax_tree(state_dtype):
    """JAX's {"params", "opt"}: gemma2's params, one AdamW update taken so
    that count and the moments are not zero."""
    params = jtf.init_lm(jax.random.PRNGKey(0),
                         jax_get_config("gemma2-2b").reduced())
    rc = JaxRunConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                      adam_state_dtype=state_dtype)
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), params)
    params, opt, _ = jax_adamw.adamw_update(
        grads, jax_adamw.init_opt(params, rc), params, rc)
    return {"params": params, "opt": opt}


def _port_tree(jtree):
    """The same tree as tensors, bf16 leaves exact (bf16 -> fp32 -> bf16)."""
    host = jax.tree_util.tree_map(np.asarray, jtree)
    return bridge.from_jax(host, "cpu",
                           types={jax_adamw.OptState: adamw.OptState})


def _bits(x) -> bytes:
    """A leaf's bytes: a tensor's (bf16 as its int16 words) or a JAX / numpy
    array's (ml_dtypes bf16 is its 2-byte words too)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _assert_same_bits(a, b):
    la, lb = list(ckpt._items(a)), list(ckpt._items(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (key, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, key
        assert _bits(x) == _bits(y), key


def _manifest(step_dir):
    m = json.loads((step_dir / "manifest.json").read_text())
    m.pop("time")
    return m


@pytest.fixture(scope="module", params=STATE_DTYPES)
def trees(request):
    jtree = _jax_tree(request.param)
    return jtree, _port_tree(jtree)


def test_port_tree_keeps_jax_dtypes(trees):
    jtree, tree = trees
    jleaves = jax.tree_util.tree_leaves(jtree)
    leaves = [v for _, v in ckpt._items(tree)]
    assert len(jleaves) == len(leaves)
    for x, y in zip(jleaves, leaves):
        assert str(x.dtype) == str(y.dtype).removeprefix("torch.")
        assert _bits(x) == _bits(y)


def test_manifest_and_bytes_equal_jax(trees, tmp_path):
    jtree, tree = trees
    jax_ckpt.save(tmp_path / "jax", 7, jtree, {"loss": 2.5})
    ckpt.save(tmp_path / "port", 7, tree, {"loss": 2.5})
    j, p = tmp_path / "jax" / "step_00000007", tmp_path / "port" / \
        "step_00000007"
    mj, mp = _manifest(j), _manifest(p)
    for key in ("step", "keys", "shapes", "dtypes", "metadata"):
        assert mp[key] == mj[key], key
    assert "opt/.count" in mp["keys"] and "opt/.m/embed" in mp["keys"]
    assert (p / "arrays.npz").read_bytes() == (j / "arrays.npz").read_bytes()


def test_port_round_trip_is_bit_exact(trees, tmp_path):
    _, tree = trees
    ckpt.save(tmp_path, 3, tree)
    template = jax.tree_util.tree_map(torch.zeros_like, tree)
    back = ckpt.restore(tmp_path, 3, template)
    assert isinstance(back["opt"], adamw.OptState)
    assert list(back["params"]) == list(tree["params"])      # dict order
    _assert_same_bits(back, tree)


def test_jax_checkpoint_restores_in_port(trees, tmp_path):
    jtree, tree = trees
    jax_ckpt.save(tmp_path, 5, jtree)
    template = jax.tree_util.tree_map(torch.zeros_like, tree)
    _assert_same_bits(ckpt.restore(tmp_path, 5, template), tree)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree = _jax_tree("float32")
    ckpt.save(tmp_path, 2, _port_tree(jtree))
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jtree)
    back = jax_ckpt.restore(str(tmp_path), 2, abstract)
    assert type(back["opt"]) is jax_adamw.OptState
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtree)):
        assert x.dtype == y.dtype and _bits(x) == _bits(y)


def test_restore_casts_to_the_template(tmp_path):
    """Each leaf takes its template's dtype: bf16 moments restore into an
    fp32 state exactly (bf16 -> fp32 is exact)."""
    tree = _port_tree(_jax_tree("bfloat16"))
    ckpt.save(tmp_path, 1, tree)
    template = jax.tree_util.tree_map(
        lambda t: torch.zeros(t.shape, dtype=torch.float32)
        if t.dtype == torch.bfloat16 else torch.zeros_like(t), tree)
    back = ckpt.restore(tmp_path, 1, template)
    for (key, x), (_, y) in zip(ckpt._items(back), ckpt._items(tree)):
        assert x.dtype == (torch.int32 if key == "opt/.count"
                           else torch.float32)
        assert torch.equal(x, y.to(x.dtype)), key


def test_restore_writes_into_the_template(tmp_path):
    """restore copies into the template's own tensors (no second copy of
    the tree) and returns the template."""
    tree = _port_tree(_jax_tree("float32"))
    ckpt.save(tmp_path, 1, tree)
    template = jax.tree_util.tree_map(torch.zeros_like, tree)
    ptrs = [t.data_ptr() for _, t in ckpt._items(template)]
    back = ckpt.restore(tmp_path, 1, template)
    assert back is template
    assert [t.data_ptr() for _, t in ckpt._items(back)] == ptrs
    _assert_same_bits(back, tree)


def test_restore_refuses_a_wrong_shape_and_a_mesh(tmp_path):
    ckpt.save(tmp_path, 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, 1, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="mesh"):
        ckpt.restore(tmp_path, 1, {"a": torch.zeros(3)}, mesh=object())


def test_latest_step(tmp_path):
    assert ckpt.latest_step(tmp_path / "none") is None
    assert ckpt.latest_step(tmp_path) is None
    for s in (2, 10, 4):
        ckpt.save(tmp_path, s, {"a": torch.zeros(1)})
    assert ckpt.latest_step(tmp_path) == 10
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_async_checkpointer_keeps_two(tmp_path):
    c = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        c.save(s, {"a": torch.full((2,), float(s))})
    c.wait()
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000003", "step_00000004"]
    assert len(c.saved) == 4
    back = ckpt.restore(tmp_path, 4, {"a": torch.zeros(2)})
    assert torch.equal(back["a"], torch.full((2,), 4.0))


def test_async_save_copies_before_it_returns(tmp_path):
    """The tree is updated in place right after `save` returns, while the
    thread may still write: the step's arrays are those before the update."""
    tree = _port_tree(_jax_tree("float32"))
    before = jax.tree_util.tree_map(torch.clone, tree)
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    c.save(1, tree)
    for _, t in ckpt._items(tree):
        t.add_(1)
    c.wait()
    template = jax.tree_util.tree_map(torch.zeros_like, tree)
    _assert_same_bits(ckpt.restore(tmp_path, 1, template), before)


def test_async_checkpointer_raises_a_failed_save(tmp_path):
    (tmp_path / "file").write_text("")
    c = ckpt.AsyncCheckpointer(str(tmp_path / "file"))
    c.save(1, {"a": torch.zeros(1)})
    with pytest.raises(OSError):
        c.wait()
