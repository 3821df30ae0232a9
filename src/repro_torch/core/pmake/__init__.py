"""pmake: parallel make-like, file-based workflow scheduler (Rogers 2021,
§2.1), the port's copy of the JAX package's `repro.core.pmake`.

Every task corresponds to output files; rules describe how to build outputs
from inputs.  A single managing process reads `rules.yaml` + `targets.yaml`,
builds the task DAG, assigns an earliest-finish-time priority (total
node-hours of a task plus its transitive successors), and greedily pushes
the highest-priority runnable task onto free nodes via popen'd shell
scripts (`rulename.n.sh` -> `rulename.n.log`).  Existing outputs are never
rebuilt (file-based restart => campaign-level fault tolerance).  The
files are read by the port's own YAML-subset reader (`rules.load_yaml`).
"""
from repro_torch.core.pmake.rules import (Rule, Target, parse_rules,
                                          parse_targets)
from repro_torch.core.pmake.graph import Task, build_graph
from repro_torch.core.pmake.scheduler import PMake

__all__ = ["Rule", "Target", "parse_rules", "parse_targets", "Task",
           "build_graph", "PMake"]
