"""The port's meshes (``repro_torch/launch/mesh.py``) at the reference's
pod sizes, on torch's ``fake`` process-group backend (collectives that
move no data), in a subprocess: a process group is per process.

* ``make_production_mesh()`` at a world of 256 is a (16, 16)
  ``("data", "model")`` ``DeviceMesh``, ``multi_pod=True`` at 512 a
  (2, 16, 16) ``("pod", "data", "model")`` one; worlds of 255 and 1 (and
  no process group at all) raise, naming the world's size;
* ``moe_mlp_ep`` placed on the (16, 16) mesh at Granite-MoE-3B-A800M's
  full width pads its 40 experts to 48, 3 a rank, and gathers their
  FSDP d: the shapes only (the fake collectives return uninitialised
  data);
* ``data_shard_count`` reads a ``DeviceMesh`` as it reads a
  ``LocalMesh`` of the same sizes; ``axis_size`` and ``axis_group`` take
  both.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import torch_cpu  # noqa: F401
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as TMESH

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.base import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.models import moe as MOE

torch.set_num_threads(1)
out = {}
RULES = {"batch": ["data"], "batch_model": ["data", "model"],
         "model": ["model"], "none": [None]}


def world(n):
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def refusal(**kw):
    try:
        M.make_production_mesh(device_type="cpu", **kw)
    except ValueError as e:
        return str(e)


def shard_counts(mesh):
    counts = {}
    for name, axes in RULES.items():
        with SH.axis_rules(mesh, {"batch": tuple(axes)}):
            counts[name] = SH.data_shard_count()
    return counts


out["no_group"] = refusal()
world(256)
mesh = M.make_production_mesh(device_type="cpu")
out["single"] = {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
                 "sizes": M.axis_sizes(mesh),
                 "group_sizes": {a: dist.get_world_size(M.axis_group(mesh, a))
                                 for a in mesh.mesh_dim_names},
                 "shard_counts": shard_counts(mesh),
                 "multi_pod_refusal": refusal(multi_pod=True)}
cfg = get_config("granite_moe_3b_a800m").replace(param_dtype=torch.float32,
                                                 compute_dtype=torch.float32)
E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
# the rank's blocks as the plans place them: 16 does not divide the 40
# experts, so they are whole on model; d FSDP over data
specs = {"router": (None, None), "w_in": (None, "data", None),
         "w_gate": (None, "data", None), "w_out": (None, None, "data")}
p = {"router": torch.zeros(d, E), "w_in": torch.zeros(E, d // 16, f),
     "w_gate": torch.zeros(E, d // 16, f), "w_out": torch.zeros(E, f, d // 16)}
seen = {}
dispatch, ffn = MOE._dispatch_indices, MOE._expert_ffn


def rec_dispatch(idx, E_, C):
    seen["E_pad"], seen["C"] = E_, C
    return dispatch(idx, E_, C)


def rec_ffn(w, xe, act):
    seen["w"] = {k: list(v.shape) for k, v in w.items()}
    seen["xe"] = list(xe.shape)
    return ffn(w, xe, act)


MOE._dispatch_indices, MOE._expert_ffn = rec_dispatch, rec_ffn
with SH.axis_rules(mesh, SH.train_rules(), SH.Placement(
        batch_axes=("data",), params={"layers": {"mlp": specs}})):
    y, aux = MOE.moe_mlp_ep(p, cfg, torch.randn(1, 32, d), mesh)
seen["y"] = list(y.shape)
seen["aux"] = sorted(aux)
seen["padding"] = list(MOE.expert_padding(E, 16))
out["ep"] = seen
world(512)
mesh = M.make_production_mesh(multi_pod=True, device_type="cpu")
out["multi"] = {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
                "single_refusal": refusal()}
world(255)
out["w255"] = refusal()
world(1)
out["w1"] = refusal()
out["w1_mesh"] = shard_counts(M.make_compat_mesh((1, 1), ("data", "model"),
                                                 "cpu"))
dist.destroy_process_group()
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def fake():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_production_mesh_at_a_world_of_256(fake):
    s = fake["single"]
    assert s["shape"] == [16, 16] and s["names"] == ["data", "model"]
    assert s["sizes"] == {"data": 16, "model": 16}
    assert s["group_sizes"] == {"data": 16, "model": 16}
    assert "needs 512 ranks; the world has 256" in s["multi_pod_refusal"]


def test_multi_pod_mesh_at_a_world_of_512(fake):
    m = fake["multi"]
    assert m["shape"] == [2, 16, 16]
    assert m["names"] == ["pod", "data", "model"]
    assert "needs 256 ranks; the world has 512" in m["single_refusal"]


@pytest.mark.parametrize("key,n", [("w255", 255), ("w1", 1),
                                   ("no_group", 1)])
def test_other_worlds_raise_naming_the_size(fake, key, n):
    assert fake[key] == ("make_production_mesh: the (16, 16) pod mesh "
                         f"needs 256 ranks; the world has {n}")


def test_ep_layer_shapes_on_the_production_mesh(fake):
    """Granite's 40 experts pad to 48 on the 16-way model axis, 3 a rank,
    their d gathered over data; a rank's data block of x (1, 32, 1536) is
    1 x 2 tokens after its model cut, capacity 4, its experts see 16
    sources' buffers, and y leaves as the data block."""
    ep = fake["ep"]
    assert ep["padding"] == [48, 3] and ep["E_pad"] == 48 and ep["C"] == 4
    assert ep["w"] == {"w_in": [3, 1536, 512], "w_gate": [3, 1536, 512],
                       "w_out": [3, 512, 1536]}
    assert ep["xe"] == [3, 16 * 4, 1536]
    assert ep["y"] == [1, 32, 1536]
    assert ep["aux"] == ["load_balance", "router_z"]


def local_counts(mesh):
    rules = {"batch": ("data",), "batch_model": ("data", "model"),
             "model": ("model",), "none": (None,)}
    out = {}
    for name, axes in rules.items():
        with SH.axis_rules(mesh, {"batch": axes}):
            out[name] = SH.data_shard_count()
    return out


def test_data_shard_count_reads_both_kinds_of_mesh(fake):
    pod = TMESH.LocalMesh({"data": 16, "model": 16})
    assert fake["single"]["shard_counts"] == local_counts(pod) == {
        "batch": 16, "batch_model": 256, "model": 16, "none": 1}
    assert fake["w1_mesh"] == local_counts(TMESH.make_local_mesh()) == {
        "batch": 1, "batch_model": 1, "model": 1, "none": 1}
    assert TMESH.axis_size(pod, "model") == 16
    assert TMESH.axis_group(pod, "model") is None
