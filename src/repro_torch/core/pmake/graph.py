"""pmake task-graph construction: resolve desired outputs to producing
rules, recursing through inputs until files exist on disk (make semantics:
"stop searching when it finds all the files needed")."""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.core.pmake.rules import (Rule, Target, expand_loop,
                                          match_output, staged_format)


@dataclass
class Task:
    key: str                       # "rule.var@dirname"
    rule: Rule
    dirname: str
    ctx: dict                      # fully staged substitution context
    inputs: list = field(default_factory=list)    # paths (relative dirname)
    outputs: list = field(default_factory=list)
    deps: set = field(default_factory=set)        # task keys
    succs: set = field(default_factory=set)
    priority: float = 0.0

    @property
    def node_hours(self) -> float:
        return self.rule.resources.node_hours

    def script_name(self) -> str:
        var = self.ctx.get("_var")
        return f"{self.rule.name}{'.' + str(var) if var is not None else ''}"


def _format_files(tmpl_dict: dict, ctx: dict) -> dict:
    return {k: staged_format(str(v), ctx) for k, v in tmpl_dict.items()}


def build_graph(rules: dict, targets: dict, root: str = ".") -> dict[str, Task]:
    """Returns task key -> Task with deps/succs wired."""
    tasks: dict[str, Task] = {}
    producers: dict[tuple, str] = {}   # (dirname, filename) -> task key

    def want(filename: str, target: Target, t_ctx: dict):
        """Ensure a task exists that produces `filename` in target.dirname.
        Returns the producing task key, or None if the file pre-exists."""
        path = Path(root) / target.dirname / filename
        key = (target.dirname, filename)
        if key in producers:
            return producers[key]
        if path.exists():
            return None
        for rule in rules.values():
            binding = match_output(rule, filename)
            if binding is None:
                continue
            # paper's substitution order: target attrs, loop vars, rule attrs
            ctx = dict(target.attrs)
            ctx.update(t_ctx)
            ctx.update(binding)
            var = rule.template_var()
            ctx["_var"] = binding.get(var) if var else None
            inp = _format_files(rule.inp, ctx)
            for combo in expand_loop(rule.loop, ctx):
                ctx.update(combo)
            out = _format_files(rule.out, ctx)
            ctx["inp"] = inp
            ctx["out"] = out
            tkey = f"{rule.name}.{ctx['_var']}@{target.dirname}" \
                if ctx["_var"] is not None else f"{rule.name}@{target.dirname}"
            if tkey in tasks:
                producers[key] = tkey
                return tkey
            task = Task(key=tkey, rule=rule, dirname=target.dirname, ctx=ctx,
                        inputs=list(inp.values()), outputs=list(out.values()))
            tasks[tkey] = task
            for o in out.values():
                producers[(target.dirname, o)] = tkey
            # recurse into inputs
            for f in inp.values():
                dep = want(f, target, t_ctx)
                if dep is not None:
                    task.deps.add(dep)
            return tkey
        raise FileNotFoundError(
            f"no rule produces {filename!r} (target {target.name}) and the "
            f"file does not exist at {path}")

    for target in targets.values():
        base_ctx = dict(target.attrs)
        for f in _format_files(target.out, base_ctx).values():
            want(f, target, base_ctx)
        for combo in expand_loop(target.loop, base_ctx):
            ctx = dict(base_ctx, **combo)
            for f in _format_files(target.tgt, ctx).values():
                want(f, target, ctx)

    for t in tasks.values():
        for d in t.deps:
            tasks[d].succs.add(t.key)
    assign_priorities(tasks)
    return tasks


def assign_priorities(tasks: dict[str, Task]):
    """EFT priority (paper §2.1): total node-hours consumed by a task and
    all its transitive successors, computed leaf-to-root."""
    memo: dict[str, float] = {}

    def closure_hours(key: str, depth=0) -> float:
        if key in memo:
            return memo[key]
        if depth > len(tasks) + 1:
            raise ValueError("cycle in pmake task graph")
        t = tasks[key]
        # transitive successor set (not sum-of-subtrees: avoid double count)
        seen: set = set()
        stack = list(t.succs)
        while stack:
            s = stack.pop()
            if s in seen:
                continue
            seen.add(s)
            stack.extend(tasks[s].succs)
        memo[key] = t.node_hours + sum(tasks[s].node_hours for s in seen)
        return memo[key]

    for k, t in tasks.items():
        t.priority = closure_hours(k)
