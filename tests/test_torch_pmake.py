"""Port parity for pmake: the programs of tests/test_pmake.py and
tests/test_system.py::test_pmake_campaign_files, run through the JAX
package's `PMake` and the port's in separate directories, must give the
same task keys, dependencies, EFT priorities, rendered scripts (the
directory they `cd` into aside), stats and files on disk.

The port reads rules.yaml / targets.yaml with its own reader of a YAML
subset (`repro_torch.core.pmake.rules.load_yaml`); it is held to
`yaml.safe_load` on every text those programs and the campaigns use, on
scalars of each implicit type, and must raise `ValueError` on constructs
outside the subset."""
import math
from dataclasses import asdict

import pytest

yaml = pytest.importorskip("yaml")

import repro.core.pmake as jax_pmake  # noqa: E402
import repro.core.pmake.rules as jax_rules  # noqa: E402
import repro.launch.campaign as jax_campaign  # noqa: E402
import repro_torch.core.pmake as port_pmake  # noqa: E402
import repro_torch.core.pmake.rules as port_rules  # noqa: E402
import repro_torch.launch.campaign as port_campaign  # noqa: E402
from test_pmake import RULES, TARGETS  # noqa: E402

FAIL_RULES = """
bad:
  resources: {time: 1, nrs: 1}
  out: {o: "bad.txt"}
  script: "exit 3"
after:
  resources: {time: 1, nrs: 1}
  inp: {o: "bad.txt"}
  out: {p: "after.txt"}
  script: "echo hi > after.txt"
"""
FAIL_TARGETS = """
t:
  dirname: .
  out: {p: "after.txt"}
"""
MISSING_TARGETS = 'u:\n  dirname: .\n  out: {x: "nope.out"}\n'
FILES_RULES = """
gen:
  resources: {time: 1, nrs: 1}
  out: {d: "data_{n}.txt"}
  script: "echo payload-{n} > data_{n}.txt"
sum:
  resources: {time: 1, nrs: 1}
  inp: {a: "data_1.txt", b: "data_2.txt"}
  out: {s: "summary.txt"}
  script: "cat data_1.txt data_2.txt > summary.txt"
"""
FILES_TARGETS = 't:\n  dirname: .\n  out: {s: "summary.txt"}\n'


def _campaign_texts(mod, **extra):
    fmt = dict(python="/usr/bin/python3", arch="gemma2-2b", steps=6,
               batch=4, seq=64, src="/work/src", shards=2, **extra)
    raw = mod.RULES_TMPL.format(**fmt)
    full = raw.replace("  inp:\n    loop:\n", "  inp:\n" + "".join(
        f"    m{n}: \"shard_{n}.jsonl\"\n" for n in range(2)))
    return [raw, full, mod.TARGETS_TMPL.format(shards=2)]


TEXTS = {
    "pmake_rules": RULES, "pmake_targets": TARGETS,
    "fail_rules": FAIL_RULES, "fail_targets": FAIL_TARGETS,
    "missing_targets": MISSING_TARGETS, "files_rules": FILES_RULES,
    "files_targets": FILES_TARGETS, "empty": "", "comments": "\n# c\n\n",
    **{f"jax_campaign_{i}": t
       for i, t in enumerate(_campaign_texts(jax_campaign))},
    **{f"port_campaign_{i}": t
       for i, t in enumerate(_campaign_texts(port_campaign, device="cpu"))},
    "nested": "a:\n  b:\n    c: 1   # c\n    d:\n  e: |\n    x\n\n      y\n\n"
              "f: 'it''s' # q\n",
    "flow": 'r: {a: "x, {y}", b: -2, c: {d: 1.5},}\ns: {}\n',
    "escapes": 'k: "tab\\there \\"q\\" \\u00e9 \\\\"\n',
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_reader_equals_safe_load(name):
    text = TEXTS[name]
    assert port_rules.load_yaml(text) == yaml.safe_load(text)


SCALARS = ["10", "-7", "+5", "1_000", "0x1F", "017", "0b101", "190:20:30",
           "0", "00", "08", "0o17", "1.5", "1.", ".5", "1.0e+3", "1e3",
           "-1:30.5", ".inf", "-.inf", ".NaN", "true", "False", "Yes", "off",
           "ON", "~", "null", "Null", "abc", "a b", "range(1,4)", "a#b",
           "a #b", "?x", "-x", ":x", "y", "n", "{a: 1}", "'q'", '"d"', ""]


@pytest.mark.parametrize("scalar", SCALARS)
def test_reader_types_scalars_as_safe_load(scalar):
    text = f"k: {scalar}\n"
    got, want = port_rules.load_yaml(text)["k"], yaml.safe_load(text)["k"]
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert type(got) is type(want) and got == want


OUTSIDE = ["- a\n", "k: [1, 2]\n", "k:\n  - a\n", "k: &a x\n", "k: *a\n",
           "k: !!str x\n", "k: >\n  folded\n", "k: |-\n  x\n",
           "k: 2001-12-14\n", "---\nk: 1\n", "k: a\n  continued\n",
           "k: 'open\n  quote'\n", "k: {a: 1,\n  b: 2}\n", "\tk: 1\n",
           "k: a: b\n", "k: {a: [1]}\n", 'k: "x" y\n', "k: %x\n", "k: @x\n",
           "plain scalar\n", "a:\n    b: 1\n  c: 2\n", "k: <<\n"]


@pytest.mark.parametrize("text", OUTSIDE)
def test_reader_raises_outside_the_subset(text):
    with pytest.raises(ValueError, match="YAML subset"):
        port_rules.load_yaml(text)


@pytest.mark.parametrize("rules,targets", [(RULES, TARGETS),
                                           (FAIL_RULES, FAIL_TARGETS),
                                           (FILES_RULES, FILES_TARGETS)])
def test_parsed_rules_and_targets_equal(rules, targets):
    pr, jr = port_rules.parse_rules(rules), jax_rules.parse_rules(rules)
    assert list(pr) == list(jr)
    for name in jr:
        assert asdict(pr[name]) == asdict(jr[name])
        assert pr[name].template_var() == jr[name].template_var()
        assert pr[name].resources.node_hours == jr[name].resources.node_hours
    pt, jt = port_rules.parse_targets(targets), jax_rules.parse_targets(targets)
    assert {k: asdict(v) for k, v in pt.items()} == \
        {k: asdict(v) for k, v in jt.items()}


@pytest.mark.parametrize("filename", ["an_7.npy", "an_x12.npy", "foo.trj",
                                      "an_.npy", "an_a.b.npy"])
def test_template_matching_equal(filename):
    p = port_rules.parse_rules(RULES)["analyze"]
    j = jax_rules.parse_rules(RULES)["analyze"]
    assert port_rules.match_output(p, filename) == \
        jax_rules.match_output(j, filename)


@pytest.mark.parametrize("prefix,var", [("", "1"), ("ab_", "x12"),
                                        ("a.b", "007"), ("__", "x")])
def test_template_roundtrip_equal(prefix, var):
    t = prefix + "{n}" + ".out"
    pm = port_rules.template_regex(t).match(prefix + var + ".out")
    jm = jax_rules.template_regex(t).match(prefix + var + ".out")
    assert pm.group("n") == jm.group("n") == var
    assert port_rules.expand_loop({"n": "range(1,4)", "m": [0, 1]}, {}) == \
        jax_rules.expand_loop({"n": "range(1,4)", "m": [0, 1]}, {})


def _graph(tasks):
    return {k: (t.rule.name, t.dirname, t.inputs, t.outputs, sorted(t.deps),
                sorted(t.succs), t.priority, t.node_hours, t.script_name())
            for k, t in tasks.items()}


def _params(root):
    (root / "System1").mkdir()
    for n in range(1, 4):
        (root / "System1" / f"{n}.param").write_text(f"param{n}")


def test_graph_and_eft_priority_equal(tmp_path):
    roots = {}
    for side in ("jax", "port"):
        roots[side] = tmp_path / side
        roots[side].mkdir()
        _params(roots[side])
    mods = {"jax": jax_pmake, "port": port_pmake}
    graphs = {s: m.build_graph(m.parse_rules(RULES), m.parse_targets(TARGETS),
                               root=str(roots[s])) for s, m in mods.items()}
    assert _graph(graphs["port"]) == _graph(graphs["jax"])
    assert len(graphs["port"]) == 6
    sims = [t for t in graphs["port"].values() if t.rule.name == "simulate"]
    assert abs(sims[0].priority - (20.0 + 1 / 6)) < 1e-9


def _files(root):
    """Every file under root: name -> text, with the root's path in the
    rendered scripts replaced."""
    return {p.relative_to(root).as_posix():
            p.read_text().replace(str(root), "<root>")
            for p in sorted(root.rglob("*")) if p.is_file()}


def _run(mod, root, rules, targets, **kw):
    pm = mod.PMake(rules, targets, root=str(root), **kw)
    return pm, pm.run()


def _without_wall(stats):
    return {k: v for k, v in stats.items() if k != "wall_s"}


def test_full_run_and_restart_equal(tmp_path):
    out = {}
    for side, mod in (("jax", jax_pmake), ("port", port_pmake)):
        root = tmp_path / side
        root.mkdir()
        _params(root)
        pm, stats = _run(mod, root, RULES, TARGETS, total_nodes=4)
        scripts = {k: pm.render_script(t).replace(str(root), "<root>")
                   for k, t in pm.tasks.items()}
        started = sorted(e["task"] for e in pm.log if e["event"] == "start")
        pm2, stats2 = _run(mod, root, RULES, TARGETS, total_nodes=4)
        out[side] = (_without_wall(stats), scripts, started, _files(root),
                     _without_wall(stats2), pm2.log, _graph(pm.tasks))
    assert out["port"] == out["jax"]
    stats, _, started, files, stats2, log2, _ = out["port"]
    assert stats == {"tasks": 6, "done": 6, "errors": 0} and len(started) == 6
    assert "simulate 2.param" in files["System1/an_2.npy"]
    assert "System1/simulate.2.sh" in files and \
        "System1/simulate.2.log" in files
    assert stats2["done"] == stats2["tasks"] == 0 and log2 == []


def test_failure_poisons_successors_equal(tmp_path):
    out = {}
    for side, mod in (("jax", jax_pmake), ("port", port_pmake)):
        root = tmp_path / side
        root.mkdir()
        pm, stats = _run(mod, root, FAIL_RULES, FAIL_TARGETS, total_nodes=1)
        out[side] = (_without_wall(stats), sorted(pm.errors), _files(root))
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"tasks": 2, "done": 0, "errors": 2}


def test_missing_rule_is_reported_by_both(tmp_path):
    for mod in (jax_pmake, port_pmake):
        with pytest.raises(FileNotFoundError, match="nope.out"):
            mod.PMake("", MISSING_TARGETS, root=str(tmp_path))


def test_node_limited_parallelism_equal(tmp_path):
    """One node: the 10-node simulate runs clamped, and no two tasks
    overlap."""
    out = {}
    for side, mod in (("jax", jax_pmake), ("port", port_pmake)):
        root = tmp_path / side
        root.mkdir()
        _params(root)
        pm, stats = _run(mod, root, RULES, TARGETS, total_nodes=1)
        spans = sorted((e["t"], e["task"]) for e in pm.log)
        starts = [e for e in pm.log if e["event"] == "start"]
        assert all(e["nodes"] == 1 for e in starts)
        ends = {e["task"]: e["t"] for e in pm.log if e["event"] == "done"}
        order = sorted(starts, key=lambda e: e["t"])
        for a, b in zip(order, order[1:]):
            assert ends[a["task"]] <= b["t"]
        out[side] = (_without_wall(stats), _files(root), len(spans))
    assert out["port"] == out["jax"]
    assert out["port"][0]["done"] == 6


def test_eft_launch_order_equal(tmp_path):
    """Inproc, one node, a runner that records: both launch the tasks in the
    same order, each only after its dependencies, highest priority first
    among those ready."""
    orders = {}
    for side, mod in (("jax", jax_pmake), ("port", port_pmake)):
        root = tmp_path / side
        root.mkdir()
        _params(root)
        order = []
        pm = mod.PMake(RULES, TARGETS, root=str(root), total_nodes=1,
                       transport="inproc",
                       runner=lambda t, order=order: order.append(t.key)
                       or True)
        stats = pm.run()
        assert stats["done"] == 6 and stats["errors"] == 0
        for i, key in enumerate(order):
            assert pm.tasks[key].deps <= set(order[:i])
        orders[side] = order
    assert orders["port"] == orders["jax"]


def test_campaign_files_equal(tmp_path):
    out = {}
    for side, mod in (("jax", jax_pmake), ("port", port_pmake)):
        root = tmp_path / side
        root.mkdir()
        pm, stats = _run(mod, root, FILES_RULES, FILES_TARGETS, total_nodes=2)
        out[side] = (_without_wall(stats), _files(root), _graph(pm.tasks))
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"tasks": 3, "done": 3, "errors": 0}
    assert out["port"][1]["summary.txt"] == "payload-1\npayload-2\n"


def test_detect_mpirun_equal(monkeypatch):
    from repro.core.pmake.scheduler import detect_mpirun as jax_detect
    from repro_torch.core.pmake.scheduler import detect_mpirun as port_detect
    res = port_rules.Resources(time=1, nrs=3, cpu=4, gpu=2, ranks=5)
    for env in ({}, {"SLURM_JOB_ID": "1"}, {"LSB_JOBID": "2"}):
        monkeypatch.delenv("SLURM_JOB_ID", raising=False)
        monkeypatch.delenv("LSB_JOBID", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert port_detect(res) == jax_detect(res)
