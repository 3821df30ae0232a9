"""Cells cut to a size the CPU runs in seconds, for the tests: the same
configuration files and mixes, with small widths, few layers, short
prompts, few clients and small batches."""
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import spec  # noqa: E402

SMALL = {"d_model": 128, "n_heads": 4, "n_kv_heads": 4, "head_dim": 32,
         "d_ff": 256, "vocab_size": 512, "n_layers": 2}


def small_config(config: dict) -> dict:
    return dict(config, model=dict(config["model"], **SMALL))


def small_cell(workload: str):
    cell = spec.load(workload)
    t = dict(cell.traffic, prompt_len=40, max_new=4, check_requests=4,
             clients=4, max_batch=2)
    return dataclasses.replace(cell, config=small_config(cell.config),
                               traffic=t)
