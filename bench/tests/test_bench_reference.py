"""The plain reference against the program at small sizes on the CPU: the
forward's logits in fp32, and the served tokens (bf16, through the front
door's serving step) by their logit gap."""
import numpy as np
import pytest
import torch

from bench.tests.small import small_config
from bench.harness import serve, spec, weights
from bench.reference import lm

CONFIGS = ["deepseek-7b.serve.backlog4k"]


def program(workload):
    from repro_torch.models.common import Options
    from repro_torch.models.model import build_model
    config = small_config(spec.load(workload).config)
    model = build_model(serve.port_config(config), Options(q_block=16,
                                                           kv_block=16))
    return config, model


def fp32_weights(config, model, seed):
    skel = model.init(torch.Generator().manual_seed(0), "meta")
    return weights.make(skel, config["init"], seed, "cpu",
                        dtype=torch.float32)


@pytest.mark.parametrize("workload", CONFIGS)
@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_forward_logits_match_in_fp32(workload, seed):
    config, model = program(workload)
    params = fp32_weights(config, model, seed)
    toks = torch.from_numpy(np.random.default_rng(seed % 1000).integers(
        0, config["model"]["vocab_size"], size=(2, 37)))
    ours = model.forward(params, {"tokens": toks}, dtype=torch.float32)
    ref = lm.logits_at(params, config["model"], toks, list(range(37)))
    V = config["model"]["vocab_size"]
    err = (ours[..., :V].float() - ref).abs().max().item()
    assert err < 2e-4 * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("workload", CONFIGS)
def test_served_tokens_are_the_references_best(workload):
    from repro_torch.runtime.serve_step import greedy_generate
    config, model = program(workload)
    skel = weights.layout(model)
    params = weights.make(skel, config["init"], 11, "cpu")
    S, new = 33, 6
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, config["model"]["vocab_size"], size=(3, S)))
    out = greedy_generate(model, params, {"tokens": toks}, new, S + new + 1)
    seq = torch.cat([toks, out[:, :-1]], dim=1)
    ref = lm.logits_at(params, config["model"], seq, list(range(S - 1,
                                                                 S + new - 1)))
    gap = ref.max(-1).values - ref.gather(-1, out[..., None])[..., 0]
    assert gap.max().item() < 0.05
    # a token altered where it is produced reads far off
    bad = (out + 1) % config["model"]["vocab_size"]
    gap_bad = ref.max(-1).values - ref.gather(-1, bad[..., None])[..., 0]
    assert gap_bad.max().item() > 0.2
