"""Cases and array helpers shared by ``tests/test_torch_moe_ep*.py``, the
reference's process (``moe_ep_reference.py``) and the port's ranks
(``moe_ep_ranks.py``).  numpy only: each side imports its own framework.

Layer: Granite-MoE's smoke layer (d 128) with 2 of E experts a token and
d_ff 32, x (4, 12, 128), on the (1, 2), (2, 2), (1, 4) and (4, 1) meshes
at capacity factors 1.0 (drops) and 8.0 (none), and with 5 experts on
(1, 3) (``E_pad`` 6).  Steps: 3 train steps of the Granite-MoE and
Qwen3-MoE smoke configs on (2, 2) and (1, 4), the Granite prefill on
(2, 2), at B 4, S 64 as ``test_torch_launch_steps.py``'s.
"""
import numpy as np

B, S = 4, 64                     # the steps' batch
LAYER_B, LAYER_S = 4, 12         # S divides by 1, 2, 3 and 4
D_FF = 32

# (name, mesh shape, capacity factor, experts)
LAYER_CASES = [(f"m{a}x{b}_cf{cf:g}", (a, b), cf, 4)
               for a, b in ((1, 2), (2, 2), (1, 4), (4, 1))
               for cf in (1.0, 8.0)] + [
    (f"m1x3_e5_cf{cf:g}", (1, 3), cf, 5) for cf in (1.0, 8.0)]
# (name, arch, mesh shape, steps)
STEP_CASES = [(f"train_{arch.split('_')[0]}_m{a}x{b}", arch, (a, b), 3)
              for arch in ("granite_moe_3b_a800m", "qwen3_moe_235b_a22b")
              for a, b in ((2, 2), (1, 4))]
PREFILL_CASES = [("prefill_granite_m2x2", "granite_moe_3b_a800m", (2, 2))]


def layer_specs(E: int, shape):
    """One MoE layer's parameter specs on a ``shape`` mesh, as a placed
    step's tree holds them (the reference's plans: the experts split over
    ``model``, FSDP over ``data`` on d; the router whole): the experts
    whole on ``model`` where its ranks do not divide E."""
    M = "model" if E % shape[1] == 0 else None
    return {"router": (None, None), "w_in": (M, "data", None),
            "w_gate": (M, "data", None), "w_out": (M, None, "data")}


def world_of(shape) -> int:
    return int(np.prod(shape))


def flat(tree, prefix=""):
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflat(arrays, prefix):
    """The entries of ``arrays`` under ``prefix`` as a nested dict."""
    tree = {}
    for key, v in arrays.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def layer_inputs(d: int, seed: int = 3):
    """The layer cases' weights for 4 and 5 experts (the reference's init
    scales), x and the objective's weights c (``sum(y * c)``), from a
    seed."""
    rng = np.random.RandomState(seed)
    out = {}
    for E in (4, 5):
        out[f"layer_E{E}/router"] = rng.randn(d, E) / np.sqrt(d)
        out[f"layer_E{E}/w_in"] = rng.randn(E, d, D_FF) / np.sqrt(d)
        out[f"layer_E{E}/w_gate"] = rng.randn(E, d, D_FF) / np.sqrt(d)
        out[f"layer_E{E}/w_out"] = rng.randn(E, D_FF, d) / np.sqrt(D_FF * 4)
    out["layer_x"] = rng.randn(LAYER_B, LAYER_S, d)
    # the objective's weights: a mean over the tokens, as a loss is
    out["layer_c"] = rng.randn(LAYER_B, LAYER_S, d) / (LAYER_B * LAYER_S)
    return {k: v.astype(np.float32) for k, v in out.items()}


def step_batches(vocab: int, seed: int = 11):
    """The train batch (``test_torch_launch_steps.run_train``'s arrays)
    and a prefill batch of prompts of random lengths, the first full."""
    rng = np.random.RandomState(seed)
    train = {"tokens": rng.randint(0, vocab, (B, S)).astype(np.int32),
             "loss_mask": (rng.rand(B, S) < 0.8).astype(np.float32),
             "advantages": rng.randn(B, S).astype(np.float32),
             "old_logprobs": (-2.0 + 0.1 * rng.randn(B, S))
             .astype(np.float32)}
    lens = rng.randint(S // 2, S + 1, size=B).astype(np.int32)
    lens[0] = S
    prefill = {"tokens": rng.randint(1, vocab, (B, S)).astype(np.int32),
               "prompt_lens": lens}
    return ({f"train_batch/{k}": v for k, v in train.items()}
            | {f"prefill_batch/{k}": v for k, v in prefill.items()})
