"""The port's RL session against the reference's, on the CPU.

``RLSession.from_config(SessionConfig(task="logic", ...)).run()`` on both
packages at a tiny size (d_model 32, 2 layers, 8 slots, 2 groups, 3 SFT
steps, greedy decode of up to 8 tokens), the port started from the reference's own
starting weights (``init_params(PRNGKey(seed))`` through
``repro_torch.convert``), in on-policy and partial mode under the
``sorted`` and ``baseline`` policies.  Both runs must give:

* the same SFT losses (``LOSS_TOL``);
* the same trained uids, update by update, in the same order, with the
  same policy version stamped on each token (partial mode: stitched
  pi_old across weight syncs);
* the same greedy token streams (logprobs within ``LP_TOL``); a token
  that differs is reported with the two logprobs around it, so that an
  f32 near-tie shows its gap;
* the same update history (``HIST_TOL``) and the same evals and
  ``final_eval`` (rewards of identical streams, so exactly).

Tolerances (f32): the reference jits its SFT and train steps, and XLA
fuses and reorders their f32 sums; the port runs them eagerly.
``LOSS_TOL`` and ``HIST_TOL`` (rtol 1e-4, atol 1e-6) cover that order
after a few AdamW steps; ``LP_TOL`` (1e-4) is the engines' logprob bound
of ``tests/test_torch_engine.py``.
"""
import jax
import numpy as np
import pytest

from repro.core.buffer import Mode as JMode
from repro.rl import session as JS
from repro_torch import convert
from repro_torch.core.buffer import Mode
from repro_torch.rl import session as TS

LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
HIST_TOL = dict(rtol=1e-4, atol=1e-6)
LP_TOL = 1e-4
SIZE = dict(task="logic", d_model=32, layers=2, rollout_batch=8,
            update_batch=8, n_groups=2, sft_steps=3, eval_size=8,
            eval_every=100, temperature=0.0, max_gen_len=8, max_total_len=64)


def _record(session):
    """Per update: [(uid, generated tokens, behaviour logprobs, versions)]
    in the order the trainer received them."""
    log = []
    handle = session.trainer.handle

    def spy(req):
        log.append([(e.uid, list(e.generated), list(e.logprobs),
                     list(e.versions)) for e in req.entries])
        return handle(req)
    session.trainer.handle = spy
    return log


def _run_both(mode, policy):
    ref = JS.RLSession.from_config(JS.SessionConfig(
        mode=JMode(mode), policy=policy, **SIZE))
    ref_log = _record(ref)
    ref_out = ref.run()

    jm = JS.build_model(JS.tiny_lm_config(len(JS.TASKS["logic"].vocab),
                                          SIZE["d_model"], SIZE["layers"]))
    jp = jm.init_params(jax.random.PRNGKey(0))       # SessionConfig.seed
    params = convert.from_jax_params(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    port = TS.RLSession.from_config(TS.SessionConfig(
        mode=Mode(mode), policy=policy, device="cpu", **SIZE), params=params)
    port_log = _record(port)
    port_out = port.run()
    return (ref, ref_log, ref_out), (port, port_log, port_out)


@pytest.mark.parametrize("policy", ["sorted", "baseline"])
@pytest.mark.parametrize("mode", ["on_policy", "partial"])
def test_tiny_session_matches_reference(mode, policy):
    (ref, ref_log, ref_out), (port, port_log, port_out) = _run_both(mode,
                                                                   policy)
    np.testing.assert_allclose(port.sft_losses, ref.sft_losses, **LOSS_TOL)
    assert len(ref.sft_losses) == SIZE["sft_steps"]

    assert [[(u, v) for u, _, _, v in b] for b in port_log] == \
        [[(u, v) for u, _, _, v in b] for b in ref_log]
    for rb, pb in zip(ref_log, port_log):
        for (uid, want, want_lp, _), (_, got, got_lp, _) in zip(rb, pb):
            first = next((i for i, (a, b) in enumerate(zip(want, got))
                          if a != b), None)
            assert first is None and len(got) == len(want), (
                f"uid {uid}: streams part at token {first}: reference "
                f"{want[first:first + 1]} (logprob "
                f"{want_lp[first:first + 1]}), port {got[first:first + 1]} "
                f"(logprob {got_lp[first:first + 1]})")
            np.testing.assert_allclose(got_lp, want_lp, atol=LP_TOL, rtol=0)

    assert len(port_out["history"]) == len(ref_out["history"]) >= 2
    for want, got in zip(ref_out["history"], port_out["history"]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **HIST_TOL)
    assert port_out["evals"] == ref_out["evals"]
    assert port_out["final_eval"] == ref_out["final_eval"]
    assert (port_out["rollout_metrics"]["updates"]
            == ref_out["rollout_metrics"]["updates"])
    if mode == "partial":
        assert port_out["rollout_metrics"]["tokens_discarded"] == 0
    stitched = sum(len(set(v)) > 1 for b in port_log for *_, v in b)
    assert stitched == 0 if mode == "on_policy" or policy == "baseline" \
        else stitched > 0


@pytest.mark.parametrize("kw,needs", [
    ({"engine": "sim"}, "SimEngine"),
    ({"num_replicas": 2}, "EngineGroup"),
    ({"fault_plan": [(1, 0, "kill")]}, "num_replicas > 1"),
    ({"autoscaler": "bubble_target"}, "Autoscaler"),
    ({"arrival": {"kind": "poisson"}}, "ServingOrchestrator")])
def test_options_of_later_slices_raise(kw, needs):
    """The options a later slice brought in now build what the reference
    builds; only ``fault_plan`` on a single engine still raises, with the
    reference's ``ValueError``."""
    cfg = TS.SessionConfig(device="cpu", sft_steps=0, d_model=16, layers=1,
                           rollout_batch=4, update_batch=4, eval_size=4,
                           **kw)
    if "fault_plan" in kw:
        with pytest.raises(ValueError, match=needs):
            TS.RLSession.from_config(cfg)
        return
    orch = TS.RLSession.from_config(cfg).orchestrator
    built = {type(orch).__name__, type(orch.engine).__name__,
             type(getattr(orch, "autoscaler", None)).__name__}
    assert needs in built, built


def test_session_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``device=None`` means the card: without one the session refuses
    rather than quietly running on the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.RLSession.from_config(TS.SessionConfig())
