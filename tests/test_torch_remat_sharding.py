"""``cfg.remat`` and the one-device sharding module of the port.

* ``remat``: every family's forward (dense, Gemma2's local/global pairs,
  MoE with its aux sums, the vlm behind patch rows, the Zamba2 hybrid,
  Whisper's encoder and decoder, xLSTM's pairs) gives the same loss and
  gradients with ``cfg.remat`` as without it, in f32 on the CPU at each
  smoke config, and the same output bit for bit under ``no_grad``.  Each
  group is recomputed in the backward: the dense forward runs its blocks
  twice under ``remat`` and once without.  Tolerance: atol 1e-6 on the
  loss and every gradient leaf (the recomputed forward repeats the same
  CPU ops, so the values come out equal; the tolerance is the gate's).
* ``repro_torch.distributed.sharding`` against
  ``repro.distributed.sharding`` on the cases of
  ``tests/test_sharding.py``; inside a context the port takes a stand-in
  mesh whose ``.shape`` maps ``"data"`` to a count, and pads as the
  reference's ``pad_update_batch`` does at that count.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401
from repro.distributed import sharding as JS
from repro_torch.configs.base import get_smoke_config
from repro_torch.distributed import sharding as TS
from repro_torch.models import transformer as TF
from repro_torch.models.model import build_model
from repro_torch.train.optimizer import tree_leaves

GRAD_ATOL = 1e-6
REMAT_ARCHS = ["qwen3_0_6b", "gemma2_2b", "granite_moe_3b_a800m",
               "phi_3_vision_4_2b", "zamba2_1_2b", "whisper_small",
               "xlstm_125m"]


def _setup(arch, remat):
    cfg = get_smoke_config(arch).replace(param_dtype=torch.float32,
                                         compute_dtype=torch.float32,
                                         remat=remat)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(3))
    rng = np.random.RandomState(5)
    batch = {"tokens": torch.from_numpy(
        rng.randint(1, cfg.vocab_size, size=(2, 12)).astype(np.int64))}
    stub = {"vlm": "patch_embeds", "audio": "frames"}.get(cfg.family)
    if stub is not None:
        batch[stub] = torch.from_numpy(0.1 * rng.randn(
            2, cfg.num_stub_positions, cfg.d_model).astype(np.float32))
    return model, params, batch


def _loss_and_grads(model, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)

    def rebuild(t):
        return {k: rebuild(t[k]) for k in sorted(t)} if isinstance(t, dict) \
            else next(it)
    logits, aux = model.forward(rebuild(params), batch)
    w = torch.from_numpy(np.random.RandomState(7).randn(
        *logits.shape).astype(np.float32))
    loss = (logits * w).mean() + sum(torch.as_tensor(v) for v in aux.values())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grads


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_gives_the_same_loss_and_gradients(arch):
    base = _loss_and_grads(*_setup(arch, remat=False))
    model, params, batch = _setup(arch, remat=True)
    assert model.cfg.remat
    got = _loss_and_grads(model, params, batch)
    torch.testing.assert_close(got[0], base[0], atol=GRAD_ATOL, rtol=0)
    assert len(got[1]) == len(base[1])
    for i, (g, b) in enumerate(zip(got[1], base[1])):
        assert (g is None) == (b is None), i
        if g is not None:
            torch.testing.assert_close(g, b, atol=GRAD_ATOL, rtol=0,
                                       msg=f"{arch} leaf {i}")


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_leaves_a_no_grad_forward_bit_identical(arch):
    model, params, batch = _setup(arch, remat=True)
    plain, _, _ = _setup(arch, remat=False)
    with torch.no_grad():
        a, _ = model.forward(params, batch)
        b, _ = plain.forward(params, batch)
    assert torch.equal(a, b)


def test_remat_recomputes_each_group_in_the_backward(monkeypatch):
    calls = []
    block = TF._block

    def counted(*args, **kw):
        calls.append(1)
        return block(*args, **kw)
    monkeypatch.setattr(TF, "_block", counted)
    runs = {}
    for remat in (False, True):
        calls.clear()
        _loss_and_grads(*_setup("qwen3_0_6b", remat))
        runs[remat] = len(calls)
    layers = get_smoke_config("qwen3_0_6b").num_layers
    assert runs == {False: layers, True: 2 * layers}


# -- sharding -----------------------------------------------------------------

def _jbatch(B, W=8):
    return {"tokens": jnp.full((B, W), 3, jnp.int32),
            "loss_mask": jnp.ones((B, W), jnp.float32),
            "advantages": jnp.ones((B,), jnp.float32)}


def _tbatch(B, W=8, kind="torch"):
    b = {k: np.array(v) for k, v in _jbatch(B, W).items()}
    return {k: torch.from_numpy(v) for k, v in b.items()} \
        if kind == "torch" else b


def _stand_in_mesh(n):
    return types.SimpleNamespace(shape={"data": n})


def _jmesh():
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()).reshape(-1), ("data",))


def _equal(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(port[k]), np.asarray(ref[k]),
                                      err_msg=k)
        assert np.asarray(port[k]).dtype == np.asarray(ref[k]).dtype, k


def test_shard_count_outside_and_under_rules():
    assert TS.data_shard_count() == JS.data_shard_count() == 1
    jm = _jmesh()
    for rules in ({"batch": "data"}, {"batch": None}, {"batch": ("data",)}):
        with JS.axis_rules(jm, rules), \
                TS.axis_rules(_stand_in_mesh(jm.shape["data"]), rules):
            assert TS.data_shard_count() == JS.data_shard_count()
        with TS.axis_rules(_stand_in_mesh(4), rules):
            assert TS.data_shard_count() == (1 if rules["batch"] is None
                                             else 4)
    assert TS.data_shard_count() == 1          # context restored


@pytest.mark.parametrize("kind", ["torch", "numpy"])
@pytest.mark.parametrize("B,multiple", [(5, 4), (8, 4), (8, 1), (8, 0),
                                        (3, 8)])
def test_pad_update_batch_equals_the_reference(kind, B, multiple):
    ref = JS.pad_update_batch(_jbatch(B), multiple=multiple, pad_token=7)
    src = _tbatch(B, kind=kind)
    got = TS.pad_update_batch(src, multiple=multiple, pad_token=7)
    _equal(got, ref)
    if B % max(multiple, 1) == 0:
        assert got is src                     # aligned: the batch itself
    else:
        assert all(isinstance(v, torch.Tensor if kind == "torch"
                              else np.ndarray) for v in got.values())
        assert np.all(np.asarray(got["tokens"])[B:] == 7)
        assert np.all(np.asarray(got["loss_mask"])[B:] == 0.0)
        assert np.all(np.asarray(got["advantages"])[B:] == 0.0)


def test_shard_update_batch_identity_outside_a_context():
    b, jb = _tbatch(5), _jbatch(5)
    assert TS.shard_update_batch(b) is b
    assert JS.shard_update_batch(jb) is jb


@pytest.mark.parametrize("n", [1, 4])
def test_shard_update_batch_pads_under_a_context(n):
    with TS.axis_rules(_stand_in_mesh(n), {"batch": "data"}):
        got = TS.shard_update_batch(_tbatch(5), pad_token=7)
    _equal(got, JS.pad_update_batch(_jbatch(5), n, pad_token=7))
    assert got["tokens"].shape[0] % n == 0
    jm = _jmesh()
    with JS.axis_rules(jm, {"batch": "data"}):
        ref = JS.shard_update_batch(_jbatch(5), pad_token=7)
    with TS.axis_rules(_stand_in_mesh(jm.shape["data"]), {"batch": "data"}):
        got = TS.shard_update_batch(_tbatch(5), pad_token=7)
    _equal(got, ref)


def test_logical_constraint_is_the_identity():
    x = torch.ones(3, 4)
    assert TS.logical_constraint(x, ("batch", None)) is x
    with TS.axis_rules(_stand_in_mesh(4), {"batch": "data"}):
        assert TS.logical_constraint(x, ("batch", None)) is x
    assert JS.logical_constraint(jnp.ones((3, 4)), ("batch", None)) \
        .shape == (3, 4)


def test_entries_to_batch_pads_under_a_context():
    from repro_torch.core.buffer import BufferEntry
    from repro_torch.rl.trainer import entries_to_batch
    es = [BufferEntry(uid=i, prompt=[1, 2, 3], generated=[4, 5],
                      logprobs=[-0.5, -0.25], versions=[0, 0])
          for i in range(3)]
    plain, _ = entries_to_batch(es, lambda g, m: 1.0, pad_id=9, max_len=64,
                                device="cpu")
    assert plain["tokens"].shape[0] == 3
    with TS.axis_rules(_stand_in_mesh(4), {"batch": "data"}):
        padded, _ = entries_to_batch(es, lambda g, m: 1.0, pad_id=9,
                                     max_len=64, device="cpu")
    assert all(v.shape[0] == 4 for v in padded.values())
    for k, v in plain.items():
        assert torch.equal(padded[k][:3], v), k
    assert bool((padded["tokens"][3] == 9).all())
    for k in ("loss_mask", "advantages", "old_logprobs"):
        assert bool((padded[k][3] == 0).all()), k
