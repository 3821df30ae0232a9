"""The port's pmake-run training campaign (`repro_torch.launch.campaign`) on
the CPU: 2 shards of reduced gemma2-2b, 2 steps at seq 32, each a real
popen'd `repro_torch.launch.train --device cpu`; the report's keys and each
shard's steps, finite losses, each train log's kernel op line, and a rerun
that runs nothing and rewrites no log.  Its rules and targets build the same
task graph as the JAX campaign's text, and render the same scripts but for
the module and the --device flag."""
import json
import math
import re
import sys
from dataclasses import asdict

import pytest

pytest.importorskip("torch")

import repro.core.pmake as jax_pmake  # noqa: E402
import repro.launch.campaign as jax_campaign  # noqa: E402
import repro_torch.core.pmake as port_pmake  # noqa: E402
from repro_torch.launch import campaign  # noqa: E402

ARGV = ["--device", "cpu", "--shards", "2", "--steps", "2", "--seq", "32"]


def test_campaign_runs_and_restarts_on_the_cpu(tmp_path, capsys):
    stats = campaign.main(ARGV + ["--workdir", str(tmp_path)])
    assert stats["tasks"] == stats["done"] == 3 and stats["errors"] == 0
    report = json.loads((tmp_path / "report.json").read_text())
    assert sorted(report) == ["mean_last_loss", "shards"]
    assert [r["shard"] for r in report["shards"]] == [0, 1]
    for r in report["shards"]:
        assert sorted(r) == ["first_loss", "last_loss", "shard", "steps"]
        assert r["steps"] == 2
        assert math.isfinite(r["first_loss"]) and math.isfinite(r["last_loss"])
    assert report["mean_last_loss"] == pytest.approx(
        sum(r["last_loss"] for r in report["shards"]) / 2)
    for n in range(2):
        log = (tmp_path / f"train.{n}.log").read_text()
        assert "[train] kernel op calls flash=0 wkv=0 ssd=0" in log
        assert len(re.findall(r"\[train\] step \d+ loss", log)) == 2
        sh = (tmp_path / f"train.{n}.sh").read_text()
        assert "-m repro_torch.launch.train" in sh and "--device cpu" in sh
        assert f"--seed {n}" in sh
    assert (tmp_path / "summarize.sh").exists()
    logs = {p.name: p.stat().st_mtime_ns for p in tmp_path.glob("*.log")}
    assert len(logs) == 3

    again = campaign.main(ARGV + ["--workdir", str(tmp_path)])
    assert again["tasks"] == again["done"] == 0 and again["errors"] == 0
    assert {p.name: p.stat().st_mtime_ns
            for p in tmp_path.glob("*.log")} == logs
    assert "[campaign]" in capsys.readouterr().out


def _texts(mod, shards, **extra):
    rules = mod.RULES_TMPL.format(
        python=sys.executable, arch="gemma2-2b", steps=6, batch=4, seq=64,
        src="/work/src", shards=shards, **extra)
    rules = rules.replace("  inp:\n    loop:\n", "  inp:\n" + "".join(
        f"    m{n}: \"shard_{n}.jsonl\"\n" for n in range(shards)))
    return rules, mod.TARGETS_TMPL.format(shards=shards)


@pytest.mark.parametrize("shards", [1, 2, 5])
def test_campaign_graph_equals_jax(tmp_path, shards):
    port_rules, port_targets = _texts(campaign, shards, device="cuda")
    assert (port_rules, port_targets) == (
        campaign.with_summary_inputs(campaign.RULES_TMPL.format(
            python=sys.executable, arch="gemma2-2b", steps=6, batch=4,
            seq=64, src="/work/src", shards=shards, device="cuda"), shards),
        campaign.TARGETS_TMPL.format(shards=shards))
    jax_rules, jax_targets = _texts(jax_campaign, shards)
    pm = port_pmake.PMake(port_rules, port_targets, root=str(tmp_path))
    jm = jax_pmake.PMake(jax_rules, jax_targets, root=str(tmp_path))
    assert sorted(pm.tasks) == sorted(jm.tasks)
    assert len(pm.tasks) == shards + 1
    for k, t in pm.tasks.items():
        j = jm.tasks[k]
        assert (t.deps, t.succs, t.priority, t.inputs, t.outputs,
                t.script_name(), asdict(t.rule.resources)) == \
            (j.deps, j.succs, j.priority, j.inputs, j.outputs,
             j.script_name(), asdict(j.rule.resources))
        ours = pm.render_script(t).replace("repro_torch.", "repro.") \
            .replace(" --device cuda", "")
        assert ours == jm.render_script(j)
    assert max(pm.tasks.values(), key=lambda t: t.priority).rule.name \
        == "train"


def test_summarize_equals_jax(tmp_path, capsys):
    for n in range(3):
        (tmp_path / f"shard_{n}.jsonl").write_text("".join(
            json.dumps({"step": s, "loss": 10.0 - n - 0.5 * s}) + "\n"
            for s in range(1, 4)))
    jax_campaign.summarize(str(tmp_path), 3)
    theirs = (tmp_path / "report.json").read_text()
    campaign.summarize(str(tmp_path), 3)
    assert (tmp_path / "report.json").read_text() == theirs
    assert campaign.main(["--summarize-dir", str(tmp_path),
                          "--shards", "3"]) is None
    assert (tmp_path / "report.json").read_text() == theirs
    capsys.readouterr()


def test_campaign_flags_are_the_reference_flags_and_device():
    args = campaign.parse_args([])
    assert (args.arch, args.shards, args.steps, args.batch, args.seq,
            args.nodes, args.summarize_dir, args.device) == \
        ("gemma2-2b", 2, 6, 4, 64, 2, "", "cuda")
