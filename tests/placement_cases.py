"""Cases and array helpers shared by ``tests/test_torch_placement*.py``,
the reference's process (``placement_reference.py``) and the port's
ranks (``placement_ranks.py``).  numpy only: each side imports its own
framework.

Widths are multiples of 16 where a split is meant, since the plans test
divisibility against the production mesh's 16: H 16, Kh 8, head dim 8,
d 64, d_ff 128, V 512 (``NARROW``); ``qwen3_kh16`` has Kh 16, so that a
cache's KV heads split over ``model``.  At Kh 8 ``wk``/``wv`` stay
replicated while ``wq`` splits (the reference's specs).

* placement: the train_4k, prefill_32k and decode_32k plans of the four
  dense configs on (2, 2), (1, 4) and (4, 1): every parameter, moment,
  batch and cache leaf's block on each rank, by sha256 digest;
* train: 3 steps, B 16, S 64 (S a multiple of 16, so the
  sequence-parallel residual splits over 4): Qwen3 ``dp``, Gemma2 and
  Qwen1.5 ``tp`` with FSDP, SP, remat and 2 microbatches, on (2, 2) and
  (1, 4); Gemma2 again at B 4 on (2, 2) (the batch replicated; run
  with the placement cases);
* prefill: Qwen3's prefill_32k plan (``tp``), B 16, S 120 prompts into
  512 cache rows, on (2, 2), at Kh 8 and 16;
* serve: Qwen3's decode_32k plan (``dp``, ``seqshard``), B 16, 4 steps
  over 512 cache rows on (1, 4) and (2, 2), slots' lengths 1 to 500 (a
  block with no live row among them);
* placed serve (``PLACED_SERVE_CASES``, part ``serve``): Gemma2's
  decode_32k plan (``tp``, ``seqshard``: slots over ``data``, the ring's
  and the global rows over ``model``) at B 16 on (2, 2) and (1, 4), and
  its long_500k plan (one slot, both caches' rows over ``("data",
  "model")``) on (2, 2), (1, 4) and (4, 1), the window cut to 256
  (``gemma2_w256``: 16 blocks of it at the production mesh's 16, 256 at
  its 16 x 16; once more at the smoke config's 16, a ring 16 x 16 does
  not divide, so every rank holds it whole); Qwen1.5's and Nemotron's decode_32k plans (``decode_2d``)
  at B 16 on (2, 2), (1, 4) and (4, 1); 4 steps each over 512 cache rows
  (``serve_inputs``);
* combine: ``decode_attention`` over 4 blocks of 128 rows;
* update: ``RLTrainer.update`` of the tiny LM under ``train_rules()`` on
  (2, 1) and (4, 1), 6 rows (padded to the data shards); the same for
  Granite-MoE's smoke config (``UPDATE_MOE``), its rows split too, its
  routers on the whole batch;
* MoE (parts ``moe_<key>``, ``test_torch_placement_moe.py``): two MoE configs
  at ``NARROW`` widths (``MOE_ARCHS``: Granite-MoE with 6 experts, which
  the specs replicate over ``model``, and Qwen3-MoE with 16, which they
  split), top-2 at cf 1.25: every block of their train_4k, prefill_32k
  and decode_32k plans on the three meshes; 3 train steps (micro 2, B 16,
  S 64) on (2, 2) and (1, 4); the prefill on (2, 2); 4 serve steps
  (Granite ``seqshard`` on (2, 2) and (1, 4), Qwen3-MoE ``decode_2d`` on
  the three meshes); token ids drawn from ``MOE_IDS`` so that the
  routers crowd a few experts and drop pairs; Granite's train and
  prefill again at vocabulary 515, which 2 and 4 do not divide
  (``MOE_WHOLE_VOCAB``).
"""
import dataclasses
import hashlib
import types

import numpy as np

NARROW = dict(num_layers=2, d_model=64, num_heads=16, num_kv_heads=8,
              head_dim=8, d_ff=128, vocab_size=512)
ARCHS = {"qwen3": ("qwen3_0_6b", {}),
         "qwen3_kh16": ("qwen3_0_6b", {"num_kv_heads": 16}),
         "gemma2": ("gemma2_2b", {}),
         "gemma2_w256": ("gemma2_2b", {"sliding_window": 256}),
         "qwen1_5": ("qwen1_5_110b", {}),
         "nemotron": ("nemotron_4_340b", {})}
# the MoE configs: the moe entry replaces fields of the config's MoE
MOE_ARCHS = {
    "granite_e6": ("granite_moe_3b_a800m",
                   {"moe": dict(num_experts=6, experts_per_token=2,
                                capacity_factor=1.25)}),
    "qwen3_moe_e16": ("qwen3_moe_235b_a22b",
                      {"moe": dict(num_experts=16, experts_per_token=2,
                                   capacity_factor=1.25)})}
# Granite-MoE again at a vocabulary the model axis does not divide (515
# on 2 or 4, as its published 49,155 is on 2 or 4): every rank computes
# the whole vocabulary's logits (``sharding.vocab_split``); train and
# prefill only, a part of its own
MOE_WHOLE_VOCAB = {
    "granite_e6_v515": ("granite_moe_3b_a800m",
                        {"moe": MOE_ARCHS["granite_e6"][1]["moe"],
                         "vocab_size": 515})}
MOE_PARTS = (*MOE_ARCHS, *MOE_WHOLE_VOCAB)
ARCHS.update(MOE_ARCHS)
ARCHS.update(MOE_WHOLE_VOCAB)
MESHES = ((2, 2), (1, 4), (4, 1))
B = 16
TRAIN_S = 64
PREFILL_S = 120
SERVE_S = 500                   # cache rows _round_len(500 + 8) = 512
SERVE_STEPS = 4
TRAIN_STEPS = 3

# (name, arch key, shape name, mesh)
PLACE_CASES = [(f"place_{a}_{sh}_m{m[0]}x{m[1]}", a, sh, m)
               for a in ("qwen3", "gemma2", "qwen1_5", "nemotron")
               for sh in ("train_4k", "prefill_32k", "decode_32k")
               for m in MESHES]
PLACE_CASES += [(f"place_gemma2_long_500k_m{m[0]}x{m[1]}", "gemma2",
                 "long_500k", m) for m in MESHES]
# a shape's global batch where it is not B (long_500k serves one slot)
SHAPE_BATCH = {"long_500k": 1}
# (name, arch key, mesh, microbatches or None for the plan's, batch)
TRAIN_CASES = [(f"train_{a}_m{m[0]}x{m[1]}", a, m, micro, B)
               for a, micro in (("qwen3", None), ("gemma2", 2),
                                ("qwen1_5", 2))
               for m in ((2, 2), (1, 4))]
# B 4, which the specs replicate (16 does not divide it): the four-card
# run's case (tools/mesh_run.py), where the FSDP gathers keep the rank's
# block of the gradient instead of reduce-scattering it
REPLICATED_TRAIN = ("train_gemma2_m2x2_b4", "gemma2", (2, 2), 2, 4)
PREFILL_CASES = [(f"prefill_{a}_m2x2", a, (2, 2))
                 for a in ("qwen3", "qwen3_kh16")]
SERVE_CASES = [(f"serve_qwen3_m{m[0]}x{m[1]}", "qwen3", m)
               for m in ((1, 4), (2, 2))]
# (name, arch key, shape name, mesh): the serve steps placed in part
# ``serve`` (``test_torch_placement_serve.py``)
PLACED_SERVE_CASES = (
    [(f"serve_gemma2_decode_32k_m{m[0]}x{m[1]}", "gemma2_w256",
      "decode_32k", m) for m in ((2, 2), (1, 4))]
    + [(f"serve_gemma2_long_500k_m{m[0]}x{m[1]}", "gemma2_w256",
        "long_500k", m) for m in MESHES]
    # the smoke config's 16-row ring, which 16 x 16 does not divide: the
    # ring whole on every rank, its query heads split over ``model``
    + [("serve_gemma2_long_500k_ring16_m2x2", "gemma2", "long_500k",
        (2, 2))]
    + [(f"serve_{a}_decode_2d_m{m[0]}x{m[1]}", a, "decode_32k", m)
       for a in ("qwen1_5", "nemotron") for m in MESHES])
# the serve steps of the families not placed yet raise on a DeviceMesh
REFUSED_SERVE = {"vlm": "phi_3_vision_4_2b", "audio": "whisper_small",
                 "hybrid": "zamba2_1_2b", "ssm": "xlstm_125m"}
REFUSED_MESH = (2, 2)
# the MoE part's cases
MOE_PLACE_CASES = [(f"place_{a}_{sh}_m{m[0]}x{m[1]}", a, sh, m)
                   for a in MOE_ARCHS
                   for sh in ("train_4k", "prefill_32k", "decode_32k")
                   for m in MESHES]
MOE_TRAIN_CASES = [(f"train_{a}_m{m[0]}x{m[1]}", a, m, 2, B)
                   for a in MOE_PARTS for m in ((2, 2), (1, 4))]
MOE_PREFILL_CASES = [(f"prefill_{a}_m2x2", a, (2, 2)) for a in MOE_PARTS]
MOE_SERVE_CASES = (
    [(f"serve_granite_e6_seqshard_m{m[0]}x{m[1]}", "granite_e6",
      "decode_32k", m) for m in ((2, 2), (1, 4))]
    + [(f"serve_qwen3_moe_e16_decode_2d_m{m[0]}x{m[1]}", "qwen3_moe_e16",
        "decode_32k", m) for m in MESHES])
# token ids of the MoE cases' batches: few, so that the routers crowd
MOE_IDS = 6
# combine: (B, H, Kh, D, rows a block, blocks)
COMBINE = (6, 8, 2, 16, 128, 4)
UPDATE_MESHES = ((2, 1), (4, 1))
UPDATE_VOCAB = 61
# the MoE family's update: its routers' capacities and aux losses are the
# whole batch's, so each rank runs all the rows
UPDATE_MOE = "granite_moe_3b_a800m"


def narrow(cfg, key):
    """Either package's smoke config of arch key ``key`` at the narrow
    widths (``NARROW`` and the key's own; ``sliding_window`` replaces the
    attention's window)."""
    extra = dict(ARCHS[key][1])
    window = extra.pop("sliding_window", None)
    moe = extra.pop("moe", None)
    cfg = cfg.replace(**dict(NARROW, **extra))
    if moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    if window is not None:
        cfg = cfg.replace(attn=dataclasses.replace(cfg.attn,
                                                   sliding_window=window))
    return cfg


def serve_inputs(rows: int, S: int = SERVE_S, window: int = 256,
                 seed: int = 13):
    """token and kv_len of a placed serve case: one slot at ``window`` +
    44 (its ring wrapped; on 4 blocks of 128 global rows the last holds
    none of its rows), or ``rows`` slots of random lengths on both sides
    of the window with slot 0 at 5 (ring and global blocks with no live
    row) and slot 1 at ``window`` - 2 (its ring wraps during the 4
    steps)."""
    rng = np.random.RandomState(seed)
    token = rng.randint(1, 512, rows).astype(np.int32)
    if rows == 1:
        return {"token": token, "kv_len": np.array([window + 44], np.int32)}
    lens = rng.randint(1, S, size=rows).astype(np.int32)
    lens[0], lens[1] = 5, window - 2
    return {"token": token, "kv_len": lens}


def world_of(shape) -> int:
    return int(np.prod(shape))


def flat(tree, prefix=""):
    """Nested dict (or named tuple of dicts) -> {"a/b/c": leaf}."""
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else zip(tree._fields, tree))
    for k, v in items:
        if isinstance(v, dict) or hasattr(v, "_fields"):
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


def digest(a) -> str:
    """sha256 of an array's shape, dtype and bytes."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.shape}{a.dtype}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def draw(shape, seed):
    """A deterministic f32 array of N(0, 0.25) values."""
    rng = np.random.RandomState(seed)
    return np.asarray(0.5 * rng.randn(*shape), dtype=np.float32)


def shape_key(name: str) -> int:
    """A stable seed from a leaf's name."""
    return int(hashlib.sha256(name.encode()).hexdigest()[:7], 16)


def batch_arrays(kind: str, S: int, vocab: int = 512, seed: int = 11,
                 rows: int = B):
    """The batch of a step kind (B rows; ``rows`` for train): train (the
    launch tests' arrays), prefill (prompts of random lengths, the first
    full), decode (token, kv_len)."""
    rng = np.random.RandomState(seed)
    if kind == "train":
        return {"tokens": rng.randint(0, vocab, (rows, S)).astype(np.int32),
                "loss_mask": (rng.rand(rows, S) < 0.8).astype(np.float32),
                "advantages": rng.randn(rows, S).astype(np.float32),
                "old_logprobs": (-2.0 + 0.1 * rng.randn(rows, S))
                .astype(np.float32)}
    if kind == "prefill":
        lens = rng.randint(S // 2, S + 1, size=B).astype(np.int32)
        lens[0] = S
        return {"tokens": rng.randint(1, vocab, (B, S)).astype(np.int32),
                "prompt_lens": lens}
    # slot 0 short: on 4 blocks of 128 rows, three hold none of its rows
    lens = rng.randint(1, S, size=B).astype(np.int32)
    lens[0] = 5
    return {"token": rng.randint(1, vocab, B).astype(np.int32),
            "kv_len": lens}


def combine_inputs(seed: int = 5):
    """q (B, H, D), the cache (B, rows * blocks, Kh, D) and kv_len: slot
    0 with no live row at all, slot 1 with rows in block 0 only, slot 2
    reaching into the last block, the others random."""
    Bc, H, Kh, D, R, n = COMBINE
    rng = np.random.RandomState(seed)
    kv = rng.randint(1, R * n, size=Bc).astype(np.int32)
    kv[0], kv[1], kv[2] = 0, 37, R * n - 3
    return {"q": rng.randn(Bc, H, D).astype(np.float32),
            "k": rng.randn(Bc, R * n, Kh, D).astype(np.float32),
            "v": rng.randn(Bc, R * n, Kh, D).astype(np.float32),
            "kv_len": kv}


def leaves(tree, prefix=""):
    """{path: leaf} of a step's positional inputs (dicts, named tuples,
    tuples by index), the names both sides key their results by."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, tuple):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}{k}/"))
    return out


def entries(Entry, seed, n=6, vocab=UPDATE_VOCAB):
    """``tests/test_torch_rl.py``'s ``_entries`` (6 rows, 3 groups) as
    either package's ``BufferEntry``."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        g = int(rng.randint(1, 20))
        out.append(Entry(
            uid=100 + i,
            prompt=rng.randint(1, vocab, rng.randint(3, 12)).tolist(),
            meta=types.SimpleNamespace(prompt_id=i % 3),
            generated=rng.randint(1, vocab, g).tolist(),
            logprobs=(-4 * rng.rand(g)).tolist(),
            versions=rng.choice((0, 1, 2), g).tolist()))
    return out


def reward(toks, meta):
    return (sum(toks) % 7) / 3.0
