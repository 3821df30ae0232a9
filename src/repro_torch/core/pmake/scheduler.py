"""pmake scheduler/executor: greedy highest-priority-first onto free nodes;
the port's copy of the JAX package's `repro.core.pmake.scheduler`.

Scripts are generated as `rulename.n.sh` (set -e; cd dirname; setup;
script), executed with popen, logged to `rulename.n.log`.  {mpirun} expands
per the ambient batch scheduler (Slurm srun / LSF jsrun / local fallback),
as in the paper.  Completed outputs are trusted (file-sync restart);
non-zero exit poisons transitive successors.

Execution runs on the unified engine pool (`repro_torch.core.engine`):
tasks carry `slots` (= nrs nodes, clamped to the allocation) and the EFT
priority; the engine's launch step is exactly the paper's "greedy
highest-priority-first onto free nodes", and its trace provides the
empirical per-task launch overhead that the METG jsrun law models.
"""
from __future__ import annotations

import os
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

from repro_torch.core.pmake.graph import Task, build_graph
from repro_torch.core.pmake.rules import (parse_rules, parse_targets,
                                          staged_format)


def detect_mpirun(resources) -> str:
    n = resources.ranks * resources.nrs
    if os.environ.get("SLURM_JOB_ID"):
        return f"srun -n {n}"
    if os.environ.get("LSB_JOBID"):
        return (f"jsrun -n {resources.nrs} -a {resources.ranks} "
                f"-c {resources.cpu} -g {resources.gpu}")
    return ""        # local: run the program directly


class PMake:
    def __init__(self, rules_text: str, targets_text: str, *, root: str = ".",
                 total_nodes: int = 1, poll: float = 0.02,
                 runner: Optional[Callable] = None, transport: str = "thread",
                 tracer=None, faults=None):
        self.root = Path(root)
        self.rules = parse_rules(rules_text)
        self.targets = parse_targets(targets_text)
        self.tasks = build_graph(self.rules, self.targets, root=str(root))
        self.total_nodes = total_nodes
        self.poll = poll
        self.runner = runner          # override for tests/simulation
        self.transport = transport    # engine transport ("thread"/"inproc")
        self.tracer = tracer          # optional engine TraceRecorder
        self.faults = faults          # optional engine FaultPlan
        self.report = None            # EngineReport of the last run()
        self.futures = {}             # task key -> client Future (last run)
        self.log: list[dict] = []     # schedule trace
        self.errors: set[str] = set()

    # ------------------------------------------------------------------
    def render_script(self, task: Task) -> str:
        ctx = dict(task.ctx)
        ctx["mpirun"] = detect_mpirun(task.rule.resources)
        setup = staged_format(task.rule.setup, ctx)
        body = staged_format(task.rule.script, ctx)
        return (f"set -e\ncd {self.root / task.dirname}\n"
                f"{setup}\n{body}\n")

    def _run_task(self, task: Task) -> bool:
        sdir = self.root / task.dirname
        sdir.mkdir(parents=True, exist_ok=True)
        name = task.script_name()
        script_path = sdir / f"{name}.sh"
        log_path = sdir / f"{name}.log"
        script_path.write_text(self.render_script(task))
        if self.runner is not None:
            return bool(self.runner(task))
        with open(log_path, "w") as logf:
            proc = subprocess.Popen(["sh", str(script_path)], stdout=logf,
                                    stderr=subprocess.STDOUT)
            rc = proc.wait()
        if rc != 0:
            return False
        missing = [o for o in task.outputs
                   if not (sdir / o).exists()]
        if missing:
            raise FileNotFoundError(
                f"rule {task.rule.name} exited 0 but outputs missing: "
                f"{missing}")
        return True

    # ------------------------------------------------------------------
    def run(self) -> dict:
        """Greedy EFT run through the futures client (batch mode); returns
        summary stats.

        The engine's launch step (sort stolen tasks by priority, fill free
        slots) replaces the old popen polling loop; `slots` carries the
        clamped node count so node-limited allocations serialize exactly
        as before, and failures poison transitive successors server-side.
        This method is a shim over `repro_torch.client.Client` — the same
        front door the dynamic futures API uses.
        """
        # lazy import: repro_torch.client imports engine modules that
        # import pmake's siblings, so a module-scope import would cycle
        from repro_torch.client import Client

        done: set[str] = set()
        t0 = time.perf_counter()

        def outputs_exist(t: Task) -> bool:
            return all((self.root / t.dirname / o).exists() for o in t.outputs)

        # file-based restart: pre-complete tasks whose outputs exist
        for k, t in list(self.tasks.items()):
            if t.outputs and outputs_exist(t):
                done.add(k)

        # steal window = the whole task set: the launch step then sorts
        # every ready task by EFT priority, reproducing the old loop's
        # global "greedy highest-priority-first onto free nodes" (a narrow
        # window would only prioritize within each stolen batch)
        client = Client(
            scheduler="pmake", workers=self.total_nodes,
            transport=self.transport, steal_n=max(4, len(self.tasks)),
            poll=self.poll, tracer=self.tracer, faults=self.faults,
            resident=False,
            executor=lambda name, meta: self._run_task(self.tasks[name]))
        # submit in dependency (topological) order: the task server
        # forward-declares unknown deps as READY stubs and ignores a later
        # duplicate Create, so a dependent submitted before its producer
        # would silently drop the producer's own dependency edges
        order, seen = [], set()
        for root_key in self.tasks:
            if root_key in seen:
                continue
            seen.add(root_key)
            stack = [(root_key, iter(sorted(self.tasks[root_key].deps)))]
            while stack:
                key, deps_it = stack[-1]
                for d in deps_it:
                    if d in self.tasks and d not in seen:
                        seen.add(d)
                        stack.append((d, iter(sorted(self.tasks[d].deps))))
                        break
                else:
                    order.append(key)
                    stack.pop()
        self.futures = {}
        for k in order:
            t = self.tasks[k]
            if k in done:
                continue
            self.futures[k] = client.submit_task(
                k, deps=[d for d in t.deps if d not in done],
                priority=t.priority,
                slots=min(t.rule.resources.nrs, self.total_nodes),
                meta={"rule": t.rule.name})
        try:
            report = client.run()
        finally:
            client.close()
        self.report = report

        for name, res in report.results.items():
            if res.ok:
                done.add(name)
        self.errors |= report.errors
        # legacy schedule trace: start/done records interleaved in
        # wall-clock order, as the old polling loop emitted them
        records = []
        for name, res in report.results.items():
            t = self.tasks[name]
            records.append({"task": name, "event": "start",
                            "t": res.t_start - t0, "priority": t.priority,
                            "nodes": min(t.rule.resources.nrs,
                                         self.total_nodes)})
            records.append({"task": name, "event": "done", "ok": res.ok,
                            "t": res.t_end - t0})
        self.log.extend(sorted(records, key=lambda r: r["t"]))

        return {"tasks": len(self.tasks), "done": len(done),
                "errors": len(self.errors),
                "wall_s": time.perf_counter() - t0}
