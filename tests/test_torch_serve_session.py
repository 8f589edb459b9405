"""A serving session of the port against the reference's, on the CPU.

``RLSession.from_config(SessionConfig(arrival=..., ...)).run()`` on both
packages at the tiny size of ``tests/test_torch_session.py`` (the port
started from the reference's weights through ``repro_torch.convert``),
with two tenants, Poisson arrivals from the session's seed and a fixed
``serve_tick``, so every scheduling decision is on the simulated clock:
the same update batches (uids, token streams, version stamps), the same
per-tenant records but for wall-clock readings, the same update history
(``HIST_TOL``, that file's bound) and the same ``final_eval``.
"""
import jax
import numpy as np

import torch_cpu  # noqa: F401
from repro.rl import session as JS
from repro_torch import convert
from repro_torch.rl import session as TS
from test_torch_group_parity import _counters
from test_torch_session import HIST_TOL, SIZE, _record


def test_serving_session_matches_reference():
    serve = dict(SIZE, arrival={"kind": "poisson",
                                "rates": {"batch": 40.0, "chat": 20.0}},
                 tenants=[{"name": "batch"},
                          {"name": "chat", "weight": 2.0}],
                 serve_arrivals=12, serve_tick=0.05)
    ref = JS.RLSession.from_config(JS.SessionConfig(**serve))
    ref_log = _record(ref)
    ref_out = ref.run()
    jp = JS.build_model(JS.tiny_lm_config(
        len(JS.TASKS["logic"].vocab), SIZE["d_model"],
        SIZE["layers"])).init_params(jax.random.PRNGKey(0))
    port = TS.RLSession.from_config(
        TS.SessionConfig(device="cpu", **serve),
        params=convert.from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu"))
    port_log = _record(port)
    port_out = port.run()

    assert [[(u, g, v) for u, g, _, v in b] for b in port_log] == \
        [[(u, g, v) for u, g, _, v in b] for b in ref_log]
    tenants = [_counters(o["rollout_metrics"])["tenants"]
               for o in (ref_out, port_out)]
    assert tenants[1] == tenants[0]
    for name in ("batch", "chat"):
        t = tenants[1][name]
        assert t["admitted"] == t["completed"] == t["consumed"] >= 1
    assert len(port_out["history"]) == len(ref_out["history"]) >= 1
    for want, got in zip(ref_out["history"], port_out["history"]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **HIST_TOL)
    assert port_out["final_eval"] == ref_out["final_eval"]
