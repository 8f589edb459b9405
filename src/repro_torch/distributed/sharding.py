"""Logical-axis sharding (counterpart of ``repro/distributed/sharding.py``).

The reference's models annotate activations with logical axis names, and
an installed rule set maps them to the axes of a device mesh; its
trainer pads an update batch to the data shards' count and places one
equal slice on each.  Outside any context every function here is the
identity, as in the reference, and so is every function on a
``LocalMesh`` (one device holds every block) but the padding of
``shard_update_batch``.

On a ``DeviceMesh`` the port runs one program a rank (SPMD) on the
blocks the reference's shardings give the device at the rank's mesh
coordinates.  ``axis_rules(mesh, rules, placement=...)`` installs, beside
the rules, a :class:`Placement`: the mesh axes the step's batch rows are
split over, and the specs of the parameters and of the cache as the rank
holds them (``launch/plans.py``).  The model code then calls the
functions below at the reference's constraint sites, and they act only
under a placement on a ``DeviceMesh``:

* tensor parallelism over the axis the ``heads`` rule names (``model``,
  "the model axis" below): :func:`weight` gives a layer the rank's block
  of a weight (its FSDP dims gathered over their axes, its heads, FFN
  columns or vocabulary rows cut to the rank's), :func:`enter_columns`
  hands the residual to a column-parallel product, and
  :func:`logical_constraint` lays a product's output out as the rule
  names (a row-parallel product's partial sums reduce-scattered to the
  sequence-parallel residual or all-reduced);
* the batch's axes: a weight replicated over an axis the batch is split
  over gets a partial gradient on each rank, summed at the step's end
  (:func:`sync_grads`); an FSDP weight's gather reduce-scatters it;
* the axis the ``embed`` rule names (``data`` under ``decode_2d``,
  :func:`embed_axis`): the residual holds the rank's block of d, a
  product over d contracts it with the weight's block (``weight(...,
  embed=)``) and sums its partial results (:func:`contract`).

Gradients follow two rules, one per kind of axis.  Over the model axis a
replicated tensor's gradient is the whole gradient on every rank (the
rank computes the same values as the others), so a replicated input of
a split product sums its gradient over the axis in the backward
(``collectives.sum_grad``).  Over a batch axis each rank's loss is its
rows' part of the whole (the masked means divided by the whole batch's
token count), so a replicated weight's gradient is a partial sum.

Sums add the ranks' copies in rank order (``distributed/
collectives.py``): a replicated parameter stays the same bits on every
rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed import collectives as COL
from repro_torch.launch.mesh import axis_group, axis_sizes, is_device_mesh



class _State:
    """The installed (mesh, rules, placement), process-wide: autograd runs
    a CUDA backward (and ``torch.utils.checkpoint``'s recomputation of a
    layer's forward) on its own device threads, which must see the rules
    and placement the step installed on the calling thread (the
    reference's is thread-local: JAX traces on the calling thread).
    ``placed`` is ``ctx`` where it holds a placement on a ``DeviceMesh``,
    else None: the one attribute every function here reads first, so that
    outside a placement each costs the host one lookup.  ``sizes`` and
    ``axes`` keep the installed mesh's axis sizes and :class:`Axis`
    records (a ``DeviceMesh`` works out its shape, groups and coordinates
    anew at each ask, and the helpers ask hundreds of times a step)."""
    ctx = None
    placed = None
    sizes = None
    axes: Dict[str, Any] = {}


_state = _State()


def _install(ctx) -> None:
    _state.ctx = ctx
    _state.placed = (ctx if ctx is not None and ctx[2] is not None
                     and is_device_mesh(ctx[0]) else None)
    _state.sizes = axis_sizes(ctx[0]) if ctx is not None else None
    _state.axes = {}


@dataclasses.dataclass(frozen=True)
class Placement:
    """What a placed step holds on each rank: ``batch_axes`` the mesh
    axes its batch rows are split over (data-major, as a ``PartitionSpec``
    entry), ``params`` the parameter tree's specs (None: every parameter
    replicated), ``cache`` the cache tree's (None: no cache) and ``vocab``
    the model's vocabulary (None: any the model axis divides)."""
    batch_axes: Tuple[str, ...] = ()
    params: Any = None
    cache: Any = None
    vocab: Optional[int] = None


def _current() -> Optional[Tuple[object, Dict[str, object], Any]]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, object],
               placement: Optional[Placement] = None):
    """Install (mesh, logical -> mesh-axis rules, placement) for the
    enclosed region.  ``mesh`` is a ``LocalMesh`` or a ``DeviceMesh``
    (``launch/mesh.py``); ``rules`` maps a logical axis name to a mesh
    axis name, a tuple of them, or None (replicated).  ``placement``
    (:class:`Placement`) turns on the SPMD functions of this module."""
    prev = _current()
    _install((mesh, dict(rules), placement))
    try:
        yield
    finally:
        _install(prev)


def logical_to_spec(logical: Sequence[Optional[str]],
                    rules: Dict[str, object]) -> Tuple:
    """The spec tuple of a tensor by its logical axis names."""
    return tuple(None if name is None else rules.get(name)
                 for name in logical)


def entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes (outermost first)."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(a for a in entry if a is not None)
    return (entry,)


def _placed():
    """(mesh, rules, placement) under a placement on a ``DeviceMesh``."""
    return _state.placed


def placed() -> bool:
    """A placement is installed on a ``DeviceMesh``."""
    return _placed() is not None


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis of the current placement: its name, process group,
    size and this rank's coordinate."""
    name: str
    group: Any
    size: int
    rank: int


def _sizes(mesh) -> Dict[str, int]:
    """``axis_sizes(mesh)``, kept for the installed mesh (not to be
    mutated)."""
    ctx = _state.ctx
    return _state.sizes if ctx is not None and mesh is ctx[0] \
        else axis_sizes(mesh)


def mesh_axis(mesh, name: str) -> Axis:
    ctx = _state.ctx
    mine = ctx is not None and mesh is ctx[0]
    ax = _state.axes.get(name) if mine else None
    if ax is None:
        ax = Axis(name, axis_group(mesh, name), _sizes(mesh)[name],
                  mesh.get_local_rank(name))
        if mine:
            _state.axes[name] = ax
    return ax


def model_axis() -> Optional[Axis]:
    """The tensor-parallel axis (the one the ``heads`` rule names) when it
    splits anything: under a placement on a ``DeviceMesh``, size > 1."""
    ctx = _placed()
    if ctx is None:
        return None
    mesh, rules, _ = ctx
    name = rules.get("heads")
    if name is None or _sizes(mesh)[name] == 1:
        return None
    return mesh_axis(mesh, name)


def seq_parallel() -> bool:
    """The residual stream is split over the model axis on its sequence
    dim (the ``seq`` rule names it: train steps of the ``tp`` plans)."""
    ax = model_axis()
    return ax is not None and _current()[1].get("seq") == ax.name


def batch_axes() -> Tuple[Axis, ...]:
    """The axes of size > 1 the batch rows are split over, outermost
    first (none outside a placement)."""
    ctx = _placed()
    if ctx is None:
        return ()
    mesh, _, placement = ctx
    return tuple(mesh_axis(mesh, a) for a in placement.batch_axes
                 if _sizes(mesh)[a] > 1)


def sum_batch(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the batch's axes in rank order (not autograd):
    the whole batch's value of a per-rank partial."""
    return COL.sum_over(x, [a.group for a in batch_axes()])


def batch_count() -> int:
    """The number of blocks the batch rows are split into (1 outside a
    placement)."""
    return math.prod(a.size for a in batch_axes())


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over dim 0 of ``x``'s rows over the whole batch:
    ``x.mean(0)`` without batch axes; else the rank's rows' sum, summed
    over the batch's axes in rank order (the same bits on every rank),
    over every rank's count.  Autograd: each rank's loss is its rows'
    part of the whole (module docstring), so the backward sums the
    gradient over the axes (the gather's reduce-scatter): a whole-batch
    statistic such as the routers' density enters every rank's part."""
    n = batch_count()
    if n == 1:
        return x.mean(0)
    total = x.sum(0)
    for a in reversed(batch_axes()):
        total = COL.all_gather(total[None], a.group, 0).sum(0)
    return total / (x.shape[0] * n)


def batch_offset(counts: torch.Tensor) -> torch.Tensor:
    """The sum of ``counts`` over the batch blocks before this rank's, in
    the batch spec's block order (zeros without batch axes; not autograd):
    where this rank's rows start in a whole-batch running count."""
    axes = batch_axes()
    if not axes:
        return torch.zeros_like(counts)
    every = gather_over(counts[None], axes)
    return every[:block_index(axes)].sum(0)


def gather_batch(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's rows along ``dim`` gathered to the whole batch, in the
    batch spec's order (not autograd)."""
    return gather_over(x, batch_axes(), dim)


def gather_over(x: torch.Tensor, axes: Sequence[Axis], dim: int = 0
                ) -> torch.Tensor:
    """The blocks of a dim split over ``axes`` (outermost first) gathered
    back to the whole dim, innermost axis first (not autograd)."""
    for a in reversed(axes):
        x = torch.cat(COL._gather(x, a.group), dim=dim)
    return x


def block_over(x: torch.Tensor, axes: Sequence[Axis], dim: int = 0
               ) -> torch.Tensor:
    """This rank's block of ``x``'s dim ``dim`` split over ``axes``
    (outermost first): the inverse of :func:`gather_over` (a view)."""
    n = math.prod(a.size for a in axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"{n} blocks do not divide dim {dim} of "
                         f"{tuple(x.shape)}")
    w = x.shape[dim] // n
    return x.narrow(dim, block_index(axes) * w, w)


def step_axes(names: Sequence[str]) -> Tuple[Axis, ...]:
    """The axes among ``names`` (a spec entry's mesh axes) of size > 1
    that the activations' rows are not split over: a step's input split
    over them is gathered to the activations' rows (``decode_2d``, whose
    activations hold every row while its token and cache slots are split
    over ``data``).  None outside a placement."""
    ctx = _placed()
    if ctx is None:
        return ()
    mesh, _, placement = ctx
    return tuple(mesh_axis(mesh, a) for a in names
                 if _sizes(mesh)[a] > 1
                 and a not in placement.batch_axes)


def embed_axis() -> Optional[Axis]:
    """The axis the ``embed`` rule names where it splits anything (``data``
    under the ``decode_2d`` rules): the residual then holds the rank's
    block of d, a product over d contracts the rank's block of its weight
    (:func:`weight`'s ``embed``) and sums the partial results over the
    axis (:func:`contract`), and a norm sums its moments over it."""
    ctx = _placed()
    if ctx is None:
        return None
    mesh, rules, _ = ctx
    name = rules.get("embed")
    if name is None or _sizes(mesh)[name] == 1:
        return None
    return mesh_axis(mesh, name)


def contract(x: torch.Tensor) -> torch.Tensor:
    """The output of a product that contracted the rank's block of d,
    summed over the embed axis in rank order; ``x`` without one."""
    ax = embed_axis()
    return x if ax is None else COL.all_reduce(x, ax.group)


def embed_block(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The rank's block of ``x``'s d (dim ``dim``) over the embed axis, cut
    from the whole (a looked-up row, a norm's scale); ``x`` without one."""
    ax = embed_axis()
    if ax is None:
        return x
    return COL.to_block(x, [(ax.group, dim % x.ndim)])


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def logical_constraint(x, logical: Sequence[Optional[str]],
                       partial: bool = False):
    """The reference's sharding constraint by logical axis names.

    Under a placement on a ``DeviceMesh``: ``x`` holds the rank's batch
    rows and every other dim whole, the same on the model axis' ranks,
    or with ``partial`` a partial sum over that axis (a row-parallel
    product's output).  A dim whose rule names the model axis is cut to
    the rank's block (a partial ``x`` reduce-scattered to it); a partial
    ``x`` with no such dim is all-reduced.  The identity elsewhere, on
    the batch dims (their rows are placed with the step's inputs) and on
    the ``embed`` dim where its rule names the embed axis (``decode_2d``:
    the weights' blocks give the rank its block of d, :func:`embed_axis`).
    """
    ax = model_axis()
    if ax is None:
        return x
    mesh, rules, _ = _current()
    held = ("batch", "embed") if embed_axis() is not None else ("batch",)
    dims = [i for i, name in enumerate(logical)
            if name not in (None, "batch")
            and ax.name in entry_axes(rules.get(name))]
    for i, name in enumerate(logical):
        if name is None or name in held or i in dims:
            continue
        if any(_sizes(mesh)[a] > 1 for a in entry_axes(rules.get(name))):
            raise NotImplementedError(
                f"logical_constraint: {name!r} over {rules.get(name)}")
    if not dims:
        return COL.all_reduce(x, ax.group) if partial else x
    (dim,) = dims
    if partial:
        return COL.reduce_scatter(x, ax.group, dim)
    return COL.to_block(x, [(ax.group, dim)])


def enter_columns(h: torch.Tensor) -> torch.Tensor:
    """The residual ``h`` (B, S or its block, d) as the input of a
    column-parallel product over the model axis: the sequence-parallel
    block gathered to the whole sequence (the backward reduce-scatters
    its gradient), or the replicated ``h`` with its gradient summed over
    the axis (each rank's product reads it for its own columns)."""
    ax = model_axis()
    if ax is None:
        return h
    if seq_parallel():
        return COL.all_gather(h, ax.group, 1)
    return COL.sum_grad(h, [ax.group])


def shared(p):
    """A replicated weight (or dict of them) that takes part in a
    computation split over the model axis: its gradient summed over the
    axis.  Norms under sequence parallelism, ``q_norm``/``k_norm``."""
    ax = model_axis()
    if ax is None:
        return p
    if isinstance(p, dict):
        return {k: shared(v) for k, v in p.items()}
    return COL.sum_grad(p, [ax.group])


def seq_shared(p):
    """``shared(p)`` where the residual is sequence-parallel, else ``p``
    (a norm of the residual runs on the rank's block of the sequence)."""
    return shared(p) if seq_parallel() else p


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def param_spec(path: Sequence[str], ndim: int) -> Tuple:
    """The stored spec of parameter ``path`` (keys into the parameter
    tree) over its last ``ndim`` dims (a layer's view drops the stacked
    layer dims, which are never split); replicated without a placement
    or a parameter spec tree."""
    ctx = _placed()
    if ctx is None or ctx[2].params is None:
        return (None,) * ndim
    node = ctx[2].params
    for k in path:
        node = node[k]
    return tuple(node)[len(node) - ndim:]


def weight(w: torch.Tensor, path: Sequence[str],
           split: Optional[int] = None,
           embed: Optional[int] = None,
           sum_model: bool = True) -> torch.Tensor:
    """The rank's view of weight ``w`` for a layer's product.

    Each dim stored split over an axis other than the model axis (FSDP
    over ``data``) is gathered over it: the backward reduce-scatters the
    gradient where the batch is split over that axis (each rank's is a
    partial sum), else keeps the rank's block.  With the embed axis
    active (``decode_2d``, :func:`embed_axis`) dim ``embed``, the
    weight's d, is instead the rank's block of d over it: as stored where
    the spec splits it so, else cut from the whole.  With the model axis
    active, dim ``split`` (heads, FFN columns, vocabulary) is the rank's
    block: as stored where the spec splits it, else cut from the
    replicated weight, whose gradient is then summed over the axis; with
    ``split`` None a weight stored replicated over the model axis keeps
    its whole extent, its gradient summed over the axis (``shared``;
    not with ``sum_model`` False, where the layer's computation on it is
    the same on every rank of the axis, so its gradient is whole there),
    and one stored split keeps its block (a KV projection whose heads
    the cache holds split)."""
    ctx = _placed()
    if ctx is None:
        return w
    mesh = ctx[0]
    spec = param_spec(path, w.ndim)
    ax = model_axis()
    ex = embed_axis()
    bnames = {a.name for a in batch_axes()}
    sizes = _sizes(mesh)
    for dim in reversed(range(w.ndim)):
        for name in reversed(entry_axes(spec[dim])):
            if sizes[name] == 1 or (ax is not None and name == ax.name):
                continue
            if ex is not None and name == ex.name:
                if dim != embed:
                    raise NotImplementedError(
                        f"weight {'/'.join(path)}: dim {dim} over the embed "
                        f"axis {name!r} is not its d")
                continue
            w = COL.all_gather(w, axis_group(mesh, name), dim,
                               "reduce_scatter" if name in bnames
                               else "slice")
    if ex is not None and embed is not None \
            and ex.name not in entry_axes(spec[embed]):
        w = COL.to_block(w, [(ex.group, embed)])
    if ax is None:
        return w
    model_dims = [i for i, e in enumerate(spec) if ax.name in entry_axes(e)]
    if split is None:
        return w if model_dims or not sum_model else COL.sum_grad(
            w, [ax.group])
    if split in model_dims:
        return w
    n = w.shape[split]
    if n % ax.size:
        raise ValueError(f"weight {'/'.join(path)}: the model axis' "
                         f"{ax.size} ranks do not divide dim {split} of "
                         f"{tuple(w.shape)}")
    w = COL.sum_grad(w, [ax.group])
    blk = n // ax.size
    return w.narrow(split, ax.rank * blk, blk)


def model_block(n: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's block of an extent ``n`` split over the
    model axis ((0, n) without one)."""
    ax = model_axis()
    if ax is None:
        return 0, n
    if n % ax.size:
        raise ValueError(f"the model axis' {ax.size} ranks do not divide "
                         f"{n}")
    blk = n // ax.size
    return ax.rank * blk, (ax.rank + 1) * blk


def kv_heads_for_q(H: int, Kh: int, k_heads: int) -> Tuple[int, int]:
    """[lo, hi) of the KV heads, among the ``k_heads`` a rank's k/v hold
    (all ``Kh``, or its block of them), that its block of the ``H`` query
    heads reads (query head h reads KV head h // G, G = H / Kh: the
    global G is kept).  Raises where a rank's query heads would straddle
    a KV head's group unevenly."""
    h0, h1 = model_block(H)
    G = H // Kh
    n = h1 - h0
    if n % G and G % n:
        raise ValueError(f"{n} query heads a rank do not tile groups of "
                         f"{G} (H {H}, Kh {Kh})")
    lo, hi = h0 // G, (h1 - 1) // G + 1
    if k_heads == Kh:
        return lo, hi
    k0, _ = model_block(Kh)
    return lo - k0, hi - k0


# ---------------------------------------------------------------------------
# The vocabulary split over the model axis (the head and the loss)
# ---------------------------------------------------------------------------


def vocab_split() -> Optional[Axis]:
    """The model axis where the ``vocab`` rule names it (the head's
    logits are then the rank's block of the vocabulary) and its ranks
    divide the vocabulary; where they do not (Granite-MoE's 49,155 on 2
    or 4), every rank computes the whole vocabulary's logits, as the
    reference's compiler gives each device the whole where the specs
    replicate the head."""
    ax = model_axis()
    if ax is None or _current()[1].get("vocab") != ax.name:
        return None
    V = _current()[2].vocab
    return ax if V is None or V % ax.size == 0 else None


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """The sequence-parallel residual's block (dim 1) gathered to the
    whole sequence for a computation every rank of the model axis runs
    alike (the backward keeps the rank's block of the gradient, which is
    the same on every rank); ``x`` elsewhere."""
    if not seq_parallel():
        return x
    return COL.all_gather(x, model_axis().group, 1, grad="slice")


def split_logsumexp(lf: torch.Tensor, ax: Axis) -> torch.Tensor:
    """logsumexp over the last dim of f32 logits whose vocabulary is split
    over ``ax``: the max over the ranks (no gradient: the result does not
    depend on it), then the sum of exponentials all-reduced."""
    m = COL.max_over(lf.detach().amax(dim=-1), [ax.group])
    s = torch.exp(lf - m[..., None]).sum(dim=-1)
    return m + torch.log(COL.all_reduce(s, ax.group))


def split_pick(lf: torch.Tensor, idx: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``lf[..., idx]`` for vocabulary ids ``idx`` over a vocabulary split
    over ``ax``: the rank holding an id gives its logit, the others 0,
    all-reduced."""
    n = lf.shape[-1]
    local = idx.long() - ax.rank * n
    inside = (local >= 0) & (local < n)
    got = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return COL.all_reduce(torch.where(inside, got, torch.zeros_like(got)),
                          ax.group)


def split_argmax(x: torch.Tensor) -> torch.Tensor:
    """``argmax`` over the last dim of the whole vocabulary where ``x``
    is the rank's block of it (the first index of the max, as
    ``torch.argmax``); ``torch.argmax`` without the split."""
    ax = vocab_split()
    if ax is None:
        return torch.argmax(x, dim=-1)
    n = x.shape[-1]
    vals, idx = torch.max(x, dim=-1)
    vals = torch.stack(COL._gather(vals.contiguous(), ax.group))
    idx = torch.stack(COL._gather((idx + ax.rank * n).contiguous(),
                                  ax.group))
    best = torch.argmax(vals, dim=0, keepdim=True)   # first rank of the max
    return torch.gather(idx, 0, best)[0]


# ---------------------------------------------------------------------------
# The decode over a cache whose sequence axis is split
# ---------------------------------------------------------------------------


def cache_seq_axes(name: str = "k") -> Tuple[Axis, ...]:
    """The axes (size > 1, outermost first) the placed cache's leaf
    ``name`` splits its sequence dim (2) over; none without a placement."""
    ctx = _placed()
    if ctx is None or ctx[2].cache is None:
        return ()
    mesh, _, placement = ctx
    spec = placement.cache[name]
    return tuple(mesh_axis(mesh, a) for a in entry_axes(spec[2])
                 if _sizes(mesh)[a] > 1)


def cache_slot_axes(name: str = "k") -> Tuple[Axis, ...]:
    """The axes (size > 1, outermost first) the placed cache's leaf
    ``name`` splits its slots (dim 1) over that the activations' rows are
    not split over (:func:`step_axes`: ``decode_2d``'s ``data``); none
    without a placement, or where the slots lie as the batch's rows."""
    ctx = _placed()
    if ctx is None or ctx[2].cache is None:
        return ()
    return step_axes(entry_axes(ctx[2].cache[name][1]))


def block_index(axes: Sequence[Axis]) -> int:
    """This rank's block among the blocks a dim split over ``axes``
    (outermost first) has."""
    i = 0
    for a in axes:
        i = i * a.size + a.rank
    return i


def axis_max(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The reference's ``pmax`` over mesh axis ``axis`` of the installed
    ``DeviceMesh`` (no placement needed)."""
    mesh = _current()[0]
    return COL.max_over(x, [axis_group(mesh, axis)])


def axis_sum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The reference's ``psum`` over ``axis``, added in rank order."""
    mesh = _current()[0]
    return COL.sum_over(x, [axis_group(mesh, axis)])


def combine_decode(parts) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention over several blocks of a cache's rows from each
    block's output and log-sum-exp: ``parts`` is the list of (o (B, H, D),
    lse (B, H)) of every block, in order.  A block with no live row has
    lse -inf and weighs 0; no block with one gives zeros and -inf.  f32
    weights ``exp(lse - max)``, summed in the list's order; returns (o in
    the blocks' dtype, the combined lse)."""
    lses = torch.stack([x for _, x in parts])             # (n, B, H)
    top = torch.amax(lses, dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    o0 = parts[0][0]
    num = torch.zeros(o0.shape, dtype=torch.float32, device=o0.device)
    den = torch.zeros(top.shape, dtype=torch.float32, device=o0.device)
    for ob, lb in parts:
        w = torch.where(torch.isfinite(lb), torch.exp(lb - top),
                        torch.zeros_like(lb))
        num += w[..., None] * ob.float()
        den += w
    o = (num / torch.clamp(den, min=1e-30)[..., None]).to(o0.dtype)
    lse = torch.where(den > 0, top + torch.log(torch.clamp(den, min=1e-30)),
                      torch.full_like(den, float("-inf")))
    return o, lse


def combine_over(o: torch.Tensor, lse: torch.Tensor,
                 axes: Sequence[Axis]) -> torch.Tensor:
    """Every rank's decode output ``o`` (B, H, D) over its block of the
    cache's rows, with its ``lse`` (B, H), combined over ``axes`` into the
    attention over every block (:func:`combine_decode`, in rank order,
    the innermost axis first), the same on every rank."""
    for a in reversed(axes):
        o, lse = combine_decode(list(zip(COL._gather(o, a.group),
                                         COL._gather(lse, a.group))))
    return o


# ---------------------------------------------------------------------------
# Gradients and the update batch
# ---------------------------------------------------------------------------


def sync_grads(grads, specs) -> list:
    """Each gradient (``tree_leaves`` order, ``specs`` the parameters'
    spec tuples in the same order, or None: all replicated) summed over
    the batch axes its parameter is replicated over, in rank order: the
    whole batch's gradient, the same bits on every rank that holds the
    block."""
    axes = batch_axes()
    if not axes:
        return list(grads)
    out = []
    for i, g in enumerate(grads):
        spec = (None,) * g.ndim if specs is None else specs[i]
        held = {n for e in spec for n in entry_axes(e)}
        out.append(COL.sum_over(g, [a.group for a in axes
                                    if a.name not in held]))
    return out


def placed_global_norm(grads, specs) -> torch.Tensor:
    """The global gradient norm of the unsharded tree on every rank: each
    leaf's sum of squares summed over the axes its spec splits it over (a
    replicated leaf counted once: the MoE experts every rank of the model
    axis holds whole among them), in ``tree_leaves`` order."""
    ctx = _placed()
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    if ctx is not None and specs is not None:
        mesh = ctx[0]
        by_axes: Dict[Tuple[str, ...], list] = {}
        for i, spec in enumerate(specs):
            names = tuple(n for e in spec for n in entry_axes(e)
                          if _sizes(mesh)[n] > 1)
            if names:
                by_axes.setdefault(names, []).append(i)
        for names, idx in by_axes.items():
            summed = COL.sum_over(torch.stack([sq[i] for i in idx]),
                                  [axis_group(mesh, n) for n in names])
            for j, i in enumerate(idx):
                sq[i] = summed[j]
    return torch.sqrt(sum(sq))


def data_shard_count() -> int:
    """Total mesh extent the logical ``batch`` axis maps to under the
    installed rules: the number of equal slices an update batch is split
    into.  1 outside any context."""
    ctx = _current()
    if ctx is None:
        return 1
    mesh, rules = ctx[0], ctx[1]
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in entry_axes(rules.get("batch")))


def pad_update_batch(batch: Dict[str, object], multiple: int,
                     pad_token: int = 0) -> Dict[str, object]:
    """Pad the leading (batch) dim of every array up to a multiple, for
    torch tensors (on their device, in their dtype) and numpy arrays.

    Pad rows are inert: ``tokens`` rows are all ``pad_token`` and every
    other array is zero, so they contribute nothing to the loss (call it
    after the advantages, so batch statistics see only real rows)."""
    if multiple <= 1:
        return batch
    B = next(iter(batch.values())).shape[0]
    extra = (-B) % multiple
    if extra == 0:
        return batch
    out = {}
    for key, x in batch.items():
        fill_value = pad_token if key == "tokens" else 0
        shape = (extra,) + tuple(x.shape[1:])
        if isinstance(x, torch.Tensor):
            fill = torch.full(shape, fill_value, dtype=x.dtype,
                              device=x.device)
            out[key] = torch.cat([x, fill], dim=0)
        else:
            x = np.asarray(x)
            fill = np.full(shape, fill_value, dtype=x.dtype)
            out[key] = np.concatenate([x, fill], axis=0)
    return out


def shard_update_batch(batch: Dict[str, object], pad_token: int = 0
                       ) -> Dict[str, object]:
    """The update batch padded to a multiple of :func:`data_shard_count`
    with inert rows (:func:`pad_update_batch`) inside an
    :func:`axis_rules` context; on a ``DeviceMesh`` each array then keeps
    the rank's contiguous slice of its leading dim, the block the
    reference's ``NamedSharding(mesh, P(batch, ...))`` gives the device at
    the rank's coordinates (the ``batch`` rule's axes, outermost first).
    On a ``LocalMesh`` the padded batch; outside any context the batch
    itself."""
    ctx = _current()
    if ctx is None:
        return batch
    batch = pad_update_batch(batch, data_shard_count(), pad_token)
    mesh, rules = ctx[0], ctx[1]
    if not is_device_mesh(mesh):
        return batch
    axes = [mesh_axis(mesh, a) for a in entry_axes(rules.get("batch"))]
    n, i = math.prod(a.size for a in axes), block_index(axes)
    out = {}
    for key, x in batch.items():
        rows = x.shape[0] // n
        out[key] = x[i * rows:(i + 1) * rows]
    return out


def update_placement() -> Optional[Placement]:
    """The placement of a trainer's update under an installed
    ``axis_rules`` on a ``DeviceMesh`` with no placement of its own: the
    batch rows over the ``batch`` rule's axes (``shard_update_batch``'s
    slices), every parameter replicated; None elsewhere."""
    ctx = _current()
    if ctx is None or not is_device_mesh(ctx[0]):
        return None
    if ctx[2] is not None:
        return ctx[2]
    return Placement(entry_axes(ctx[1].get("batch")))


# ---------------------------------------------------------------------------
# Standard rule sets
# ---------------------------------------------------------------------------


def train_rules(multi_pod: bool = False) -> Dict[str, object]:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ffn": "model",
        "vocab": "model",
        "experts": "model",
        "expert_capacity": None,
        "ssm_heads": "model",
        "ssm_state": None,
        # FSDP: parameters stored sharded over the data axis on this
        # logical axis (biggest dim of each weight), gathered on use.
        "fsdp": batch,
        "cache_seq": None,
    }


def decode_rules(multi_pod: bool = False, context_parallel: bool = False
                 ) -> Dict[str, object]:
    """Decode: batch over data; long-context mode shards the KV cache's
    sequence axis over `data` (distributed flash-decode combine)."""
    batch = ("pod", "data") if multi_pod else ("data",)
    r = train_rules(multi_pod)
    if context_parallel:
        r["batch"] = ("pod",) if multi_pod else None
        r["cache_seq"] = "data"
    else:
        r["batch"] = batch
    return r
