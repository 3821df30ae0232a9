"""pmake-orchestrated training campaign (the paper's Fig. 1 pattern applied
to the framework): shard-train -> summarize, file-synced and restartable.

    PYTHONPATH=src python -m repro_torch.launch.campaign --workdir DIR \
        --shards 2 --steps 6
    PYTHONPATH=src python -m repro_torch.launch.campaign --workdir DIR \
        --shards 2 --steps 2 --seq 32 --device cpu

The flags of the JAX package's `launch/campaign.py`, plus --device, which
each train task receives; runs on the card unless --device cpu.  Each
`train` task is a real popen'd `repro_torch.launch.train` run producing a
metrics file; `summarize` aggregates shard metrics.  Re-running the
campaign rebuilds nothing (outputs exist) — campaign-level fault tolerance
exactly as in pmake's design.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

from repro_torch.core.pmake import PMake

RULES_TMPL = """
train:
  resources: {{time: 10, nrs: 1, cpu: 1}}
  out:
    metrics: "shard_{{n}}.jsonl"
  setup: export PYTHONPATH={src}
  script: |
    {python} -m repro_torch.launch.train --arch {arch} --reduced --steps {steps} \\
      --global-batch {batch} --seq {seq} --seed {{n}} \\
      --metrics-out shard_{{n}}.jsonl --device {device}
summarize:
  resources: {{time: 1, nrs: 1, cpu: 1}}
  inp:
    loop:
  out:
    report: "report.json"
  setup: export PYTHONPATH={src}
  script: |
    {python} -m repro_torch.launch.campaign --summarize-dir . --shards {shards}
"""

TARGETS_TMPL = """
campaign:
  dirname: .
  out:
    report: "report.json"
  loop:
    n: "range({shards})"
  tgt:
    metrics: "shard_{{n}}.jsonl"
"""


def summarize(directory: str, shards: int):
    rows = []
    for n in range(shards):
        path = Path(directory) / f"shard_{n}.jsonl"
        recs = [json.loads(l) for l in path.read_text().splitlines() if l]
        rows.append({"shard": n, "steps": len(recs),
                     "first_loss": recs[0]["loss"],
                     "last_loss": recs[-1]["loss"]})
    report = {"shards": rows,
              "mean_last_loss": sum(r["last_loss"] for r in rows) / len(rows)}
    (Path(directory) / "report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report, indent=1))


def with_summary_inputs(rules: str, shards: int) -> str:
    """The summarize rule depends on every shard's metrics file."""
    return rules.replace(
        "  inp:\n    loop:\n",
        "  inp:\n" + "".join(
            f"    m{n}: \"shard_{n}.jsonl\"\n" for n in range(shards)))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=str(
        Path(tempfile.gettempdir()) / "repro_torch_campaign"))
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--summarize-dir", default="")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Write rules.yaml and targets.yaml into --workdir and run them; returns
    the run's stats, or None after --summarize-dir."""
    args = parse_args(argv)

    if args.summarize_dir:
        summarize(args.summarize_dir, args.shards)
        return None

    src = str(Path(__file__).resolve().parents[2])
    rules = with_summary_inputs(RULES_TMPL.format(
        python=sys.executable, arch=args.arch, steps=args.steps,
        batch=args.batch, seq=args.seq, src=src, shards=args.shards,
        device=args.device), args.shards)
    targets = TARGETS_TMPL.format(shards=args.shards)
    Path(args.workdir).mkdir(parents=True, exist_ok=True)
    (Path(args.workdir) / "rules.yaml").write_text(rules)
    (Path(args.workdir) / "targets.yaml").write_text(targets)

    pm = PMake(rules, targets, root=args.workdir, total_nodes=args.nodes)
    # EFT check: train tasks (with the summarize successor) outrank summarize
    stats = pm.run()
    print(f"[campaign] {stats}")
    assert stats["errors"] == 0, "campaign had failures"
    return stats


if __name__ == "__main__":
    main()
