"""The port's own copies of the control plane against the reference's.

Each scenario is built twice: once wholly from ``repro`` (JAX engine,
reference ``EngineGroup``, ``FaultInjector``, controllers, autoscaler,
serving tier, session) and once wholly from ``repro_torch`` (the port's
verbatim copies of those modules over its ``SlotEngine``), on the tiny
f32 LM with the reference's starting weights carried over by
``repro_torch.convert`` and greedy decoding.  Both runs must give the
same update batches (uids, order, token streams, version stamps) and
the same counters in the metrics snapshot.  Wall-clock readings
(``WALL_KEYS``) are left out: the slot engines' clocks are real time.

* a 2-replica paged ``EngineGroup`` with ``migrate_kv=True`` whose
  ``FaultInjector`` kills replica 1 at group step 3, under ``sorted`` in
  partial mode for two groups (``async_step=False``: async micro-steps
  and the autoscaler's windows read the replicas' wall clocks, so on
  slot engines they are held to the contract suites only);
* every controller of ``core/controller.py`` over one ``SlotEngine``;
* ``RLSession.from_config(SessionConfig(engine="sim", ...)).run()`` for
  every registered policy, and with ``autoscaler="bubble_target"`` /
  ``"queue_depth"`` on 2 replicas: sim time is virtual, so the whole
  result record (scale events included) is equal, wall time aside;
* the port's ``SessionConfig`` fields are the reference's plus ``device``.
"""
import dataclasses
import importlib

import jax
import numpy as np
import pytest

import torch_cpu  # noqa: F401
from repro.core.policy import available_policies
from repro.rl import session as JS
from repro_torch import convert
from repro_torch.rl import session as TS

# readings of the wall clock (the slot engines') or derived from it
WALL_KEYS = {"elapsed", "bubble_ratio", "throughput_tok_per_s",
             "update_time_s", "update_overlap_frac", "trainer_busy_frac",
             "replica_busy", "replica_bubble_ratio", "replica_busy_time",
             "replica_cap_time", "latency", "queue_wait", "bubble_time"}

MODULES = {"buffer": "core.buffer", "orch": "core.orchestrator",
           "policy": "core.policy", "api": "core.engine_api",
           "controller": "core.controller", "group": "rollout.group",
           "engine": "rollout.engine", "logic": "data.logic"}
_P = {}


def package(root):
    """The modules of ``root`` ("repro" or "repro_torch") and its tiny LM
    (d_model 32, 1 layer, 2 heads), the port's with converted weights."""
    if root not in _P:
        mods = {k: importlib.import_module(f"{root}.{v}")
                for k, v in MODULES.items()}
        if "repro" not in _P:
            jm = JS.build_model(JS.tiny_lm_config(
                len(mods["logic"].VOCAB), d_model=32, layers=1, heads=2))
            jp = jm.init_params(jax.random.PRNGKey(0))
            _P["repro"] = dict(mods, model=jm, params=jp)
        if root == "repro_torch":
            jp = _P["repro"]["params"]
            tm = TS.build_model(TS.tiny_lm_config(
                len(mods["logic"].VOCAB), d_model=32, layers=1, heads=2),
                device="cpu")
            tp = convert.from_jax_params(jax.tree.map(np.asarray, jp),
                                         device="cpu")
            _P[root] = dict(mods, model=tm, params=tp)
    return _P[root]


def _prompts(n, seed=0, lo=3, hi=20):
    rng = np.random.RandomState(seed)
    v = len(package("repro")["logic"].VOCAB)
    return [rng.randint(3, v, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def _slot(P, capacity):
    """Greedy tiny engine; ``max_total_len`` 24 against prompts of 3-19
    ids cuts the streams at different lengths (no EOS: eos_id -1)."""
    return P["engine"].SlotEngine(
        P["model"], lambda: P["params"], capacity=capacity,
        max_total_len=24, max_gen_len=12, eos_id=-1, pad_id=0,
        temperature=0.0)


def _counters(snapshot):
    def strip(d):
        return {k: strip(v) if isinstance(v, dict) else v
                for k, v in d.items() if k not in WALL_KEYS}
    return strip(dict(snapshot))


def _recorder():
    batches = []

    def train_fn(req):
        batches.append([(e.uid, tuple(e.generated), tuple(e.versions))
                        for e in req.entries])
    return batches, train_fn


# -- a group with a kill and KV migration -------------------------------------

def _group_with_kill(root):
    P = package(root)
    mode = P["buffer"].Mode.PARTIAL
    eng = P["group"].EngineGroup(
        [_slot(P, 4) for _ in range(2)], migrate_kv=True, async_step=False,
        fault_injector=P["api"].FaultInjector([(3, 1, "kill")]))
    cfg = P["orch"].SortedRLConfig(mode=mode, rollout_batch=8, group_size=1,
                                   update_batch=4, max_gen_len=12)
    batches, train_fn = _recorder()
    orch = P["orch"].RolloutOrchestrator(
        eng, P["buffer"].StatefulRolloutBuffer(mode), cfg,
        P["policy"].make_policy("sorted"), train_fn)
    prompts = _prompts(16)
    for g in range(2):
        orch.run_group(prompts[8 * g:8 * (g + 1)])
    return batches, orch.metrics.summary(), eng.cache_stats()


def test_group_kill_and_migration_match_reference():
    ref, port = _group_with_kill("repro"), _group_with_kill("repro_torch")
    assert port[0] == ref[0]
    assert sorted(u for b in port[0] for u, _, _ in b) == list(range(16))
    assert len({len(t) for b in port[0] for _, t, _ in b}) > 1
    assert _counters(port[1]) == _counters(ref[1])
    assert _counters(port[2]) == _counters(ref[2])
    st = port[2]
    assert st["replica_deaths"] == 1 and st["alive_replicas"] == 1
    assert st["rehomed_entries"] >= 1 and st["migrated_pages"] >= 1


# -- the controllers over one engine ------------------------------------------

CONTROLLERS = {
    "sorted": ("SortedRLController", {}),
    "canonical": ("CanonicalController", {}),
    "posthoc": ("CanonicalController", {"sort_post_hoc": True}),
    "pipelined": ("PipelinedController", {}),
    "ungrouped": ("UngroupedController", {}),
}


def _controller_run(root, name):
    P = package(root)
    cls_name, kw = CONTROLLERS[name]
    mode = P["buffer"].Mode.PARTIAL
    cfg = P["orch"].SortedRLConfig(mode=mode, rollout_batch=4, group_size=2,
                                   update_batch=4, max_gen_len=12)
    batches = []

    def train_fn(entries, version):                 # the legacy callback
        batches.append((version, [(e.uid, tuple(e.generated))
                                  for e in entries]))
    prompts = _prompts(16, seed=1)
    if name == "ungrouped":
        kw = dict(kw, prompt_stream=iter([(p, None) for p in prompts]))
    ctl = getattr(P["controller"], cls_name)(
        _slot(P, 4), P["buffer"].StatefulRolloutBuffer(mode), cfg, train_fn,
        **kw)
    if name == "pipelined":
        for g in range(2):
            ctl.queue_group(prompts[8 * g:8 * (g + 1)])
        ctl.run_queued()
    elif name == "ungrouped":
        ctl.run_steps(n_updates=4)
    else:
        for g in range(2):
            ctl.run_group(prompts[8 * g:8 * (g + 1)])
    return batches, ctl.metrics.summary()


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_controllers_match_reference(name):
    ref, port = _controller_run("repro", name), _controller_run(
        "repro_torch", name)
    assert port[0] == ref[0] and len(port[0]) >= 3
    assert _counters(port[1]) == _counters(ref[1])


# -- sim sessions --------------------------------------------------------------

SIM = dict(engine="sim", n_groups=3, rollout_batch=16, update_batch=16,
           max_gen_len=64)


def _both_sessions(**kw):
    out = []
    for S in (JS, TS):
        session = S.RLSession.from_config(S.SessionConfig(**kw))
        rec = session.run()
        rec.pop("wall_time_s")
        out.append((session, rec))
    return out


@pytest.mark.parametrize("policy", available_policies())
def test_sim_session_matches_reference(policy):
    (_, ref), (_, port) = _both_sessions(policy=policy, **SIM)
    assert port == ref
    assert len(port["history"]) >= 3


@pytest.mark.parametrize("autoscaler,arrival", [
    ("bubble_target", None),
    ("queue_depth", {"kind": "poisson", "rates": {"a": 40.0, "b": 20.0}})])
def test_sim_autoscaler_session_matches_reference(autoscaler, arrival):
    (ref_s, ref), (port_s, port) = _both_sessions(
        num_replicas=2, max_replicas=3, autoscaler=autoscaler,
        autoscaler_window=0.2, arrival=arrival,
        tenants=[{"name": "a"}, {"name": "b"}] if arrival else None, **SIM)
    assert port == ref
    events = [[dataclasses.astuple(e) for e in s.orchestrator.autoscaler
               .events] for s in (ref_s, port_s)]
    assert events[1] == events[0] and len(events[1]) >= 1
    assert port["rollout_metrics"]["scale_events"] == len(events[1])


def test_session_config_fields_are_the_reference_s_plus_device():
    ref = [(f.name, f.default) for f in dataclasses.fields(JS.SessionConfig)]
    port = [(f.name, f.default)
            for f in dataclasses.fields(TS.SessionConfig)]
    assert port[:-1] == [(n, d if n != "mode" else TS.Mode(d.value))
                         for n, d in ref]
    assert port[-1] == ("device", None)
