"""The port's launch-path tables and helpers against the reference's, on
the CPU: config counts, shapes, plans, specs and the fit report's
parameter counts.

* ``param_count``/``active_param_count`` of all ten full configs and
  their smoke configs: equal integers;
* ``SHAPES`` and ``shape_by_name`` (with its ``KeyError``);
* ``PLANS`` and ``SKIPS`` field for field (``opt_dtype`` mapped from the
  jnp dtype to the torch one);
* ``param_specs``, ``activation_rules`` and ``cache_specs_for`` against
  the reference's ``PartitionSpec`` trees turned into tuples, for every
  arch's smoke tree (and its full tree for ``param_specs``) under a
  ``tp`` and a ``dp`` plan, single- and multi-pod;
* ``input_specs`` and ``cache_specs`` (meta tensors) against the
  reference's ``ShapeDtypeStruct`` trees for every arch and kind;
* the fit report's ``params_total``/``params_active`` for the ten full
  configs against the reference dryrun's count over
  ``jax.eval_shape(init_params)`` (``repro/launch/dryrun.py:106-114``,
  restated here: that module sets a 512-device XLA flag on import).

Everything here is integers, names and shapes: equality, no tolerance.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401
from repro.configs import base as JB
from repro.launch import plans as JP
from repro.models import model as JM
from repro_torch.configs import base as TB
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import plans as TP
from repro_torch.models import model as TM

ARCHS = list(TB.ARCH_IDS)
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
          jnp.int32: torch.int32}


def _dtype(d):
    return DTYPES[jnp.dtype(d).type]


def _jspecs_to_tree(tree):
    """PartitionSpec tree -> the same nested dicts of tuples."""
    return jax.tree.map(tuple, tree,
                        is_leaf=lambda x: isinstance(x, jax.sharding
                                                     .PartitionSpec))


def _plan_of(jplan):
    kw = {f.name: getattr(jplan, f.name)
          for f in dataclasses.fields(JP.Plan)}
    kw["opt_dtype"] = _dtype(kw["opt_dtype"])
    return TP.Plan(**kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(arch):
    for jcfg, tcfg in ((JB.get_config(arch), TB.get_config(arch)),
                       (JB.get_smoke_config(arch),
                        TB.get_smoke_config(arch))):
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()
        assert isinstance(tcfg.param_count(), int)


def test_full_config_counts_are_the_published_table():
    want = {"qwen3_0_6b": (596_042_752, 596_042_752),
            "gemma2_2b": (2_614_222_080, 2_614_222_080),
            "granite_moe_3b_a800m": (3_298_793_472, 882_874_368),
            "qwen3_moe_235b_a22b": (235_093_610_496, 22_190_739_456),
            "nemotron_4_340b": (341_025_638_400, 341_025_638_400),
            "phi_3_vision_4_2b": (3_821_079_552, 3_821_079_552),
            "zamba2_1_2b": (1_170_310_912, 1_170_310_912),
            "xlstm_125m": (133_890_816, 133_890_816),
            "whisper_small": (277_892_352, 277_892_352),
            "qwen1_5_110b": (111_209_914_368, 111_209_914_368)}
    got = {a: (c.param_count(), c.active_param_count())
           for a, c in TB.all_configs().items()}
    assert got == want


def test_shapes_and_shape_by_name():
    assert [dataclasses.astuple(s) for s in TB.SHAPES] == \
        [dataclasses.astuple(s) for s in JB.SHAPES]
    for s in JB.SHAPES:
        assert dataclasses.astuple(TB.shape_by_name(s.name)) == \
            dataclasses.astuple(JB.shape_by_name(s.name))
    for mod in (TB, JB):
        with pytest.raises(KeyError):
            mod.shape_by_name("train_8k")


def test_plans_and_skips_equal_field_for_field():
    assert len(TP.PLANS) == len(JP.PLANS) == 33
    assert TP.SKIPS == JP.SKIPS and len(TP.SKIPS) == 7
    assert set(TP.PLANS) == set(JP.PLANS)
    for key, jplan in JP.PLANS.items():
        assert TP.PLANS[key] == _plan_of(jplan), key
        assert TP.get_plan(*key) == _plan_of(jplan)
    for key in JP.SKIPS:
        assert TP.get_plan(*key) is None and JP.get_plan(*key) is None
    assert [f.name for f in dataclasses.fields(TP.Plan)] == \
        [f.name for f in dataclasses.fields(JP.Plan)]
    assert TP.Plan().opt_dtype is torch.float32


PLAN_CASES = {
    "tp": JP.Plan(),
    "tp_bf16_micro4": JP.Plan(microbatches=4, opt_dtype=jnp.bfloat16),
    "dp": JP.Plan(strategy="dp", fsdp=False, seq_parallel=False,
                  remat=False, decode_cache="seqshard"),
    "tp_seqshard_2axes": JP.Plan(decode_cache="seqshard", remat=False,
                                 cache_seq_axes=("data", "model")),
    "tp_decode_2d": JP.Plan(decode_cache="seqshard", remat=False,
                            decode_2d=True),
}
_TREES = {}


def _trees(arch, full):
    key = (arch, full)
    if key not in _TREES:
        get_j = JB.get_config if full else JB.get_smoke_config
        get_t = TB.get_config if full else TB.get_smoke_config
        jcfg, tcfg = get_j(arch), get_t(arch)
        jshape = jax.eval_shape(JM.build_model(jcfg).init_params,
                                jax.random.PRNGKey(0))
        tshape = TM.build_model(tcfg, device="meta").init_params(
            torch.Generator())
        _TREES[key] = (jcfg, tcfg, jshape, tshape)
    return _TREES[key]


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, full):
    jcfg, tcfg, jshape, tshape = _trees(arch, full)
    for name, jplan in PLAN_CASES.items():
        want = _jspecs_to_tree(JP.param_specs(jshape, jcfg, jplan))
        got = TP.param_specs(tshape, tcfg, _plan_of(jplan))
        assert got == want, (arch, name)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_activation_rules_equal_the_reference(kind, multi_pod):
    for name, jplan in PLAN_CASES.items():
        assert TP.activation_rules(_plan_of(jplan), multi_pod, kind) == \
            JP.activation_rules(jplan, multi_pod, kind), name


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_for_equal_the_reference(arch):
    jcfg, tcfg = JB.get_smoke_config(arch), TB.get_smoke_config(arch)
    for batch, max_len in ((32, 1024), (2, 512), (16, 4096)):
        jc = JM.cache_specs(jcfg, batch, max_len)
        tc = TM.cache_specs(tcfg, batch, max_len)
        for name, jplan in PLAN_CASES.items():
            for multi_pod in (False, True):
                want = _jspecs_to_tree(JP.cache_specs_for(
                    jc, jcfg, jplan, batch, multi_pod))
                got = TP.cache_specs_for(tc, tcfg, _plan_of(jplan), batch,
                                         multi_pod)
                assert got == want, (arch, name, batch, multi_pod)


def _same_shapes(want, got):
    assert set(want) == set(got)
    for k in want:
        if isinstance(want[k], dict):
            _same_shapes(want[k], got[k])
            continue
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == _dtype(want[k].dtype), k


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_equal_the_reference(arch):
    for full in (False, True):
        jcfg = (JB.get_config if full else JB.get_smoke_config)(arch)
        tcfg = (TB.get_config if full else TB.get_smoke_config)(arch)
        for kind in ("train", "prefill", "decode"):
            _same_shapes(JM.input_specs(jcfg, 96, 3, kind),
                         TM.input_specs(tcfg, 96, 3, kind))
        _same_shapes(JM.cache_specs(jcfg, 3, 1024),
                     TM.cache_specs(tcfg, 3, 1024))
    with pytest.raises(ValueError):
        TM.input_specs(tcfg, 8, 1, "score")


def _reference_dryrun_counts(jcfg, jshape):
    """``repro/launch/dryrun.py:106-114`` over an eval_shape tree."""
    N = N_active = 0
    for path, leaf in jtu.tree_flatten_with_path(jshape)[0]:
        size = math.prod(leaf.shape)
        N += size
        names = [str(getattr(p, "key", "")) for p in path]
        if jcfg.family == "moe" and names[-1] in ("w_in", "w_gate", "w_out") \
                and len(leaf.shape) >= 3:
            size = size * jcfg.moe.experts_per_token / jcfg.moe.num_experts
        N_active += size
    return N, N_active


@pytest.mark.parametrize("arch", ARCHS)
def test_fit_report_param_counts_equal_the_reference_dryrun(arch):
    jcfg, tcfg, jshape, tshape = _trees(arch, True)
    want = _reference_dryrun_counts(jcfg, jshape)
    got = TD.param_counts(tcfg, tshape)
    assert got == want
    assert type(got[0]) is int


def test_fit_report_record_of_a_decode_step():
    """One decode step of the full Qwen3-0.6B at decode_32k on meta
    tensors: the reference's record keys, 2 N T model FLOPs, the cache's
    bytes in the persistent bytes, and the roofline terms."""
    rec = TD.analyse("qwen3-0.6b", "decode_32k", verbose=False)
    cfg = TB.get_config("qwen3_0_6b")
    assert rec["arch"] == "qwen3-0.6b" and rec["mesh"] == "1xH100"
    assert rec["plan"]["strategy"] == "dp"
    N = rec["params_total"]
    assert N == rec["params_active"]
    assert rec["model_flops"] == 2 * N * 128
    cache = TM.cache_specs(cfg, 128, 32_768 + 512)
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    assert rec["persistent_bytes"] == 2 * N + cache_bytes + 2 * 128 * 4
    assert rec["flops"] > rec["model_flops"]      # attention over the cache
    r = rec["roofline"]
    assert r["compute_s"] == rec["flops"] / TMESH.PEAK_FLOPS_BF16
    assert r["memory_s"] == rec["persistent_bytes"] / TMESH.HBM_BW
    assert r["dominant"] == "memory"
    assert not rec["fits_80gb"] and "activations" in rec["fit_note"]


def test_fit_report_skips_and_meshes():
    rec = TD.analyse("qwen3_0_6b", "long_500k", verbose=False)
    assert rec == {"arch": "qwen3_0_6b", "shape": "long_500k",
                   "skipped": True,
                   "reason": "full attention, no windowed variant"}
    assert TMESH.make_local_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="the world has 1"):
        TMESH.make_production_mesh()
    assert np.isclose(TMESH.PEAK_FLOPS_BF16, 989e12)


def test_fit_report_skips_the_slstm_prefill_count():
    rec = TD.analyse("xlstm-125m", "prefill_32k", verbose=False)
    assert rec["skipped"] and "sLSTM" in rec["reason"]
    assert TP.get_plan("xlstm_125m", "prefill_32k") is not None
