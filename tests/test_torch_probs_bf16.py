"""The --probs-bf16 flag of the port's entry points: `launch.serve` and
`launch.train` set `Options.probs_bf16`, and every flash op call of the
families that read it (the transformer, MLA, zamba2's shared block) gets
it, at reduced size on the CPU.  What the flag computes is held against
the JAX package's blockwise attention in tests/test_torch_flash_attention.py
and, on the card, the kernel against its plain version in
tests/test_torch_flash_attention_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402


@pytest.fixture
def flash_calls(monkeypatch):
    """The probs_bf16 argument of every flash op call the run makes."""
    seen = []
    real = attn.flash_attention

    def spy(*a, **kw):
        seen.append(kw.get("probs_bf16"))
        return real(*a, **kw)

    monkeypatch.setattr(attn, "flash_attention", spy)
    return seen


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-lite-16b",
                                  "zamba2-2.7b"])
def test_serve_flag_reaches_the_flash_op(arch, flag, flash_calls):
    res = serve.main(["--arch", arch, "--device", "cpu", "--requests", "1",
                      "--prompt-len", "8", "--max-new", "2"]
                     + (["--probs-bf16"] if flag else []))
    assert res["model"].opts.probs_bf16 is flag
    assert flash_calls and all(c is flag for c in flash_calls)


@pytest.mark.parametrize("flag", [False, True])
def test_train_flag_reaches_the_flash_op(flag, flash_calls, capsys):
    res = train.main(["--arch", "gemma2-2b", "--reduced", "--steps", "1",
                      "--global-batch", "2", "--seq", "16", "--device",
                      "cpu"] + (["--probs-bf16"] if flag else []))
    assert res["model"].opts.probs_bf16 is flag
    assert flash_calls and all(c is flag for c in flash_calls)
    assert "[train] step" in capsys.readouterr().out
