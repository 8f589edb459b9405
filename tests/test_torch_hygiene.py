"""Hygiene of the PyTorch port.

* No file of ``src/repro_torch`` (nor ``chip_smoke.py``) imports JAX or
  the reference package ``repro``.
* Importing the port's engine, its RL session, its checkpoint module,
  its EngineGroup, autoscaler, serving tier and controllers leaves both
  out of ``sys.modules``.
* The port's verbatim copies of the reference's jax-free modules equal
  their originals once ``repro.`` is rewritten to ``repro_torch.``, but
  for the edits listed in ``COPY_EDITS`` (none).
* The port's copy of ``PagedKVCache`` behaves exactly as the reference's
  under random op sequences (submit, share, COW, interrupt, resume,
  evict, export/import, sync): tables, refcounts, free lists and
  ``stats_dict()`` agree after every op.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
from proptest import cases, integers, lists, tuples
from repro.core import kv_cache as ref_kv
from repro_torch.core import kv_cache as port_kv

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|,|$)"
    r"|from\s+repro(\.|\s))")


def test_port_sources_import_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
           for p in files
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if FORBIDDEN.match(line)]
    assert not bad, bad


def test_forbidden_pattern_spares_the_port_itself():
    assert FORBIDDEN.match("from repro.core import x")
    assert FORBIDDEN.match("import repro.models")
    assert FORBIDDEN.match("  import jax.numpy as jnp")
    assert not FORBIDDEN.match("from repro_torch.core import x")
    assert not FORBIDDEN.match("import repro_torch")


def test_importing_the_engine_pulls_in_no_jax():
    code = ("import sys, repro_torch.rollout.engine, repro_torch.convert, "
            "repro_torch.rl.session, repro_torch.train.checkpoint, "
            "repro_torch.train.loop, repro_torch.rollout.group, "
            "repro_torch.rollout.autoscaler, repro_torch.serve, "
            "repro_torch.core.controller; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# -- verbatim copies -----------------------------------------------------------

VERBATIM = ("core/buffer.py", "core/metrics.py", "core/policy.py",
            "core/orchestrator.py", "core/engine_api.py",
            "core/controller.py", "rl/trainer_api.py", "rollout/sim.py",
            "rollout/group.py", "rollout/autoscaler.py", "serve/__init__.py",
            "serve/arrivals.py", "serve/serving.py", "serve/tenants.py",
            "data/tokenizer.py", "data/loader.py", "data/logic.py",
            "data/math_synth.py")
# lines a copy may differ in, as (reference line, port line): none
COPY_EDITS = {}


@pytest.mark.parametrize("rel", VERBATIM)
def test_copies_equal_the_reference_with_the_import_prefix_rewritten(rel):
    want = re.sub(r"\brepro\.", "repro_torch.",
                  (ROOT / "src" / "repro" / rel).read_text())
    for old, new in COPY_EDITS.get(rel, []):
        assert want.count(old) == 1, (rel, old)
        want = want.replace(old, new)
    got = (ROOT / "src" / "repro_torch" / rel).read_text()
    assert got == want, rel


# -- the PagedKVCache copy against the reference ------------------------------

# op draw -> kind: submits and decode steps weigh most
OP_KINDS = (0, 0, 0, 1, 1, 1, 2, 3, 4, 5, 6)
KEYS = [(1,) * 20, (1,) * 20 + (2, 3), (4, 5, 6), (7,) * 40, (8,)]


def _snapshot(c):
    return (c.tables, c.tokens, c.pool.refcount.tolist(), list(c.pool._free),
            c.stats_dict(), c.resident_uids(), sorted(c._active), c.version)


def _apply(c, dst, op, a, b, uid):
    """One op on cache ``c`` (export/import lands in ``dst``).  Returns the
    op's result or the name of the exception it raised."""
    op = OP_KINDS[op]
    try:
        active = sorted(c._active)
        resident = c.resident_uids()
        if op == 0:                                 # submit / share
            key = KEYS[a % len(KEYS)]
            donor = c.find_donor(key)
            if donor is not None:
                c.share(uid, donor, key)
                return ("share", donor)
            return ("prefill", c.register_prefill(uid, key))
        if op == 1 and active:                      # decode step (COW)
            copies = c.prepare_step(active, [len(c.tokens[u])
                                             for u in active])
            c.append_tokens(active, [b] * len(active))
            return ("step", copies)
        if op == 2 and active:                      # interrupt
            c.deactivate(active[a % len(active)])
            return "interrupt"
        if op == 3 and resident:                    # resume a prefix
            u = resident[a % len(resident)]
            return ("resume", c.try_resume(u, c.tokens[u][:b]))
        if op == 4 and c.tables:                    # finish
            c.release_seq(sorted(c.tables)[a % len(c.tables)])
            return "release"
        if op == 5 and c.tables:                    # migrate to dst
            u = sorted(c.tables)[a % len(c.tables)]
            ex = c.export_pages(u)
            pages = dst.import_pages(ex)
            c.release_seq(u)
            return ("migrate", pages)
        if op == 6 and b % 8 == 0:
            return ("purge", c.purge())
        if op == 6:
            c.sync_version(c.version + 1)
            return "sync"
        return "noop"
    except Exception as e:                          # noqa: BLE001
        return type(e).__name__


@cases(max_examples=40,
       seq=lists(tuples(integers(0, len(OP_KINDS) - 1), integers(0, 9), integers(0, 30)),
                 min_size=5, max_size=60),
       retain=integers(0, 1), pages=integers(3, 12))
def test_port_kv_cache_matches_reference_under_random_ops(seq, retain, pages):
    caches = []
    for mod in (ref_kv, port_kv):
        pair = [mod.PagedKVCache(pages, 16, retain_across_sync=bool(retain))
                for _ in range(2)]
        caches.append(pair)
    for uid, (op, a, b) in enumerate(seq):
        results = [_apply(src, dst, op, a, b, uid) for src, dst in caches]
        assert results[0] == results[1], (uid, op, results)
        for i in range(2):
            assert _snapshot(caches[0][i]) == _snapshot(caches[1][i]), (uid,
                                                                        op)
            caches[1][i].check_invariants()
