"""Port parity for the sharded dwork hub (paper §6 item 4): the port's
`ShardedHub` against the JAX package's, on the same scripted verbs.

Each script runs step by step on both hubs; every response is compared as
(type name, fields), and afterwards each shard's stats, errors, completed
set, ready queue, the home map and `_all_done()`.  Home shards come from
`hash(name)`, which is the same for both hubs in one process, so each
script also checks the semantics it is about on the port alone: a failure
or a cancel in one shard poisons its dependent in another (the server's
`_new_errors` worklist), and `prune_terminal` keeps what the worklist
still needs."""
import json

import pytest

from repro.core.dwork import api as jax_api
from repro.core.dwork.sharded import ShardedHub as JaxHub
from repro_torch.core.dwork import api as port_api
from repro_torch.core.dwork.sharded import ShardedHub as PortHub

SIDES = {"jax": (jax_api, JaxHub), "port": (port_api, PortHub)}


def as_plain(r):
    if isinstance(r, tuple):                  # (response, shard) of steal
        return [as_plain(r[0]), r[1]]
    if isinstance(r, (dict, list, bool, int)) or r is None:
        return json.loads(json.dumps(r))
    return type(r).__name__, json.loads(json.dumps(r.__dict__))


def cross_pair(hub, n_shards):
    """A producer name and a dependent name homed on different shards."""
    a = "prod0"
    for i in range(256):
        b = f"dep{i}"
        if hash(b) % n_shards != hash(a) % n_shards:
            return a, b
    raise AssertionError("no cross-shard pair")


# A step is (verb, *args) on the hub:
#   ("create", name, deps)              hub.create
#   ("wire", Verb, fields)              hub.handle(api.Verb(**fields))
#   ("steal", worker, n)                hub.steal (affinity from the name)
#   ("complete", worker, task, ok)      hub.complete on the task's home
#   ("cs", worker, [(task, ok)], n)     hub.complete_steal
#   ("cancel", task) / ("exit", worker) / ("prune",) / ("stats",)
#   ("drain", n_workers, failing)       steal/complete round-robin to Exit
def scripts(a, b):
    chain = [f"c{i}" for i in range(12)]
    return {
        "cross_shard_failure_poisons_dependent": [
            ("create", a, ()), ("create", b, (a,)),
            ("steal_task", a), ("complete_home", a, False), ("stats",)],
        "cross_shard_cancel_poisons_dependent": [
            ("create", a, ()), ("create", b, (a,)), ("cancel", a),
            ("cancel", a), ("stats",)],
        "cross_shard_success_releases_proxy": [
            ("create", a, ()), ("create", b, (a,)),
            ("drain", 2, ()), ("stats",)],
        "dependent_of_already_failed_remote_dep": [
            ("create", a, ()), ("steal_task", a),
            ("complete_home", a, False), ("create", b, (a,)), ("stats",)],
        "wire_verbs_and_complete_steal": [
            *[("wire", "Create", {"task": t, "deps": [chain[i - 1]]
                                  if i % 3 else []})
              for i, t in enumerate(chain)],
            ("wire", "Steal", {"worker": "w0", "n": 2}),
            ("wire", "Steal", {"worker": "w1", "n": 2}),
            ("cs_served", "w0", 2), ("cs_served", "w1", 0),
            ("wire", "Exit", {"worker": "w1"}),
            ("wire", "Stats", {}), ("drain", 3, ("c4",)), ("stats",)],
        "prune_keeps_pending_poison_then_drops": [
            ("create", a, ()), ("create", b, (a,)),
            *[("create", f"x{i}", ()) for i in range(6)],
            ("drain_except", 2, a), ("prune",),
            ("complete_home", a, False), ("prune",), ("stats",)],
        "transfer_with_cross_shard_new_dep": [
            ("create", a, ()), ("create", "t", ()), ("steal_task", "t"),
            ("transfer", "t", (b,)), ("create", b, ()),
            ("drain", 2, ()), ("stats",)],
    }


def run(side, name, n_shards=2):
    api, hub_cls = SIDES[side]
    hub = hub_cls(n_shards)
    a, b = cross_pair(hub, n_shards)
    log = []
    holder = {}                                # task -> (worker, shard)

    def steal_until(task):
        """Steal with w0, w1, ... until `task` is served; it is held, any
        other task served on the way is completed."""
        for w in range(8):
            r, shard = hub.steal(f"w{w}", n=1, affinity=w)
            log.append(as_plain((r, shard)))
            if isinstance(r, api.TaskMsg):
                for t, _ in r.tasks:
                    if t == task:
                        holder[t] = (f"w{w}", shard)
                        return
                    log.append(as_plain(hub.complete(f"w{w}", t, shard)))
        raise AssertionError(f"{task} never stolen")

    def drain(workers, failing, spare=None):
        """Steal and complete round-robin until every worker is told to
        exit; `spare` is stolen but held (not completed), so the drain
        then ends at the first round that finds nothing to steal."""
        for t, (w, shard) in sorted(holder.items()):
            if t != spare:                     # finish what is held first
                del holder[t]
                log.append(as_plain(hub.complete(w, t, shard,
                                                 ok=t not in failing)))
        for _ in range(10_000):
            exits = found = 0
            for w in range(workers):
                r, shard = hub.steal(f"w{w}", n=1, affinity=w)
                log.append(as_plain((r, shard)))
                if isinstance(r, api.TaskMsg):
                    found += 1
                    for t, _ in r.tasks:
                        holder[t] = (f"w{w}", shard)
                        if t != spare:
                            log.append(as_plain(hub.complete(
                                f"w{w}", t, shard, ok=t not in failing)))
                elif isinstance(r, api.ExitResp):
                    exits += 1
            if exits == workers or (spare in holder and not found):
                return
        raise AssertionError("drain did not end")

    for step in scripts(a, b)[name]:
        verb, *args = step
        if verb == "create":
            hub.create(args[0], deps=list(args[1]))
        elif verb == "wire":
            r = hub.handle(getattr(api, args[0])(**args[1]))
            log.append(as_plain(r))
            if isinstance(r, api.TaskMsg):
                for t, _ in r.tasks:
                    holder[t] = (args[1]["worker"], hub.home[t])
        elif verb == "steal_task":
            steal_until(args[0])
        elif verb == "complete_home":
            w, shard = holder.pop(args[0])
            log.append(as_plain(hub.complete(w, args[0], shard, ok=args[1])))
        elif verb == "cs_served":
            # complete everything worker args[0] holds, then steal args[1]
            w = args[0]
            done = [(t, True) for t, (hw, _) in sorted(holder.items())
                    if hw == w]
            routed = [(t, ok, hub.home[t]) for t, ok in done]
            for t, _ in done:
                holder.pop(t)
            r, shard = hub.complete_steal(w, routed, n=args[1],
                                          affinity=int(w[1:]))
            log.append(as_plain((r, shard)))
            if isinstance(r, api.TaskMsg):
                for t, _ in r.tasks:
                    holder[t] = (w, shard)
        elif verb == "cancel":
            log.append(as_plain(hub.cancel(args[0])))
        elif verb == "transfer":
            w, _ = holder[args[0]]
            log.append(as_plain(hub.transfer(w, args[0], new_deps=args[1])))
        elif verb == "prune":
            log.append(("pruned", hub.prune_terminal()))
        elif verb == "stats":
            log.append(as_plain(hub.stats()))
        elif verb == "drain":
            drain(args[0], args[1])
        elif verb == "drain_except":
            drain(args[0], (), spare=args[1])
    return hub, (a, b), log


def state(hub):
    return {"shards": [{"stats": s.stats(), "errors": sorted(s.errors),
                        "completed": sorted(s.completed),
                        "ready": list(s.ready), "done": s._all_done()}
                       for s in hub.shards],
            "home": dict(sorted(hub.home.items())),
            "user_errors": sorted(hub.user_errors()),
            "stats": hub.stats()}


NAMES = sorted(scripts("a", "b"))


@pytest.mark.parametrize("name", NAMES)
def test_scripted_sharded_verbs_give_equal_responses(name):
    jax_hub, _, jax_log = run("jax", name)
    port_hub, _, port_log = run("port", name)
    assert port_log == jax_log
    assert state(port_hub) == state(jax_hub)


def test_port_server_carries_the_sharded_hook():
    from repro_torch.core.dwork.server import TaskServer
    srv = TaskServer()
    assert srv._new_errors is None            # off outside a hub
    hub = PortHub(3)
    assert all(s._new_errors == [] for s in hub.shards)


@pytest.mark.parametrize("cause", ["failure", "cancel", "failed_before"])
def test_cross_shard_dependent_is_poisoned(cause):
    """The port's versions of tests/test_client.py's
    test_sharded_failure/cancel_poisons_cross_shard_dependent: the
    dependent in the other shard fails, and every shard reaches done."""
    name = {"failure": "cross_shard_failure_poisons_dependent",
            "cancel": "cross_shard_cancel_poisons_dependent",
            "failed_before": "dependent_of_already_failed_remote_dep"}[cause]
    hub, (a, b), log = run("port", name)
    assert hub._shard_of(a) != hub._shard_of(b)
    assert b in hub.shards[hub._shard_of(b)].errors
    assert hub.user_errors() == {a, b}
    assert all(s._all_done() for s in hub.shards)
    if cause == "cancel":
        assert log[:2] == [True, False]       # a second cancel is refused


def test_cross_shard_success_and_prune_semantics():
    hub, (a, b), _ = run("port", "cross_shard_success_releases_proxy")
    assert {a, b} <= hub.shards[hub._shard_of(b)].completed | \
        hub.shards[hub._shard_of(a)].completed
    assert not hub.user_errors()
    assert all(s._all_done() for s in hub.shards)
    hub, (a, b), log = run("port", "prune_keeps_pending_poison_then_drops")
    pruned = [x[1] for x in log if isinstance(x, tuple) and x[0] == "pruned"]
    assert pruned[0] == 6                     # the finished x tasks only
    assert pruned[1] > 0                      # then a, b and their helpers
    assert all(s._all_done() for s in hub.shards)
    assert set(hub.home) == set()


def test_prune_terminal_keeps_names_on_the_poison_worklist():
    """TaskServer.prune_terminal must not drop a name still waiting in
    `_new_errors` (an errored __notify__ whose meta the hub has not read
    yet), on both sides alike."""
    out = {}
    for side, (api, hub_cls) in SIDES.items():
        hub = hub_cls(2)
        s0 = hub.shards[0]
        s0.handle(api.Create(task="bad", deps=[], meta={}))
        s0.handle(api.Create(task="__notify__p", deps=["bad"],
                             meta={"notify_shard": 1, "proxy": "p"}))
        s0.handle(api.Steal(worker="w0@0", n=1))
        s0.handle(api.Complete(worker="w0@0", task="bad", ok=False))
        kept = s0.prune_terminal()             # worklist still holds both
        s0._new_errors.clear()
        dropped = s0.prune_terminal()
        out[side] = (sorted(kept), sorted(dropped))
    assert out["port"] == out["jax"] == ([], ["__notify__p", "bad"])
