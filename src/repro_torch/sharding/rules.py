"""Logical-axis sharding rules (MaxText-style) with a divisibility-aware
resolver: the port of ``repro.sharding.rules`` onto a torch
``DeviceMesh`` and DTensor.

Parameters and caches are matched by PATH SUFFIX (the trailing dict keys
of the tree path, list indices ignored), and each rule assigns LOGICAL
axes to the TRAILING dims of the leaf.  The reference stacks a pattern
position's blocks along a leading ``repeats`` axis; the port keeps one
block per repeat (``models.transformer``'s layout), so a pattern leaf
has one dim fewer and its spec is the reference's without the leading
``None``.

Logical -> physical mesh axes:
    batch   -> ("pod", "data")   activations' batch dim
    fsdp    -> ("data",)         weights' d_model dim (FSDP within a pod)
    tp      -> ("model",)        heads / ff / experts / vocab / ssm width

A spec is a tuple with, for each dim of the leaf, ``None``, one mesh
axis name or a tuple of them (the major axis first), as jax's
``PartitionSpec`` holds them.  The resolver drops a mesh axis when it
does not divide the dim and never assigns one mesh axis twice in a spec.

A mesh is a ``DeviceMesh`` with ``mesh_dim_names`` or a
:class:`MeshShape` (axis names and sizes, no devices: the dry run's).
:func:`placements` turns a spec into DTensor placements, :func:`place`
a tree of full tensors into DTensors holding each rank's shard, and
:func:`gather` the DTensors back into full tensors, with the gradient
summed over the batch axes and scattered back to each leaf's placement.

A cache is not placed as DTensors: the sharded serving steps keep a
tree of plain local tensors on each rank, which decode writes in place,
cut by ``CACHE_RULES`` (:func:`cache_shardings`, :func:`local_shape`):
a self-attention block's ``k``/``v`` over the rank's batch rows and,
where its compute is tensor-parallel, its KV/m heads.  Where the
resolver drops "model" (KV heads the axis does not divide:
recurrentgemma-9b's one) a leaf is whole on every "model" rank, as the
reference holds it; so are the caches of the mixers whose compute stays
gathered over "model" (cross attention's ``k``/``v``, the RG-LRU's
``h``/``conv``, the SSD's ``conv_x``/``state``:
``cache_shardings(model=False)``), which ``CACHE_RULES`` would split
over "model" (MLA's ``ckv``/``krope`` it splits over the rows only).
The dry run counts the cache so (``launch.dryrun.cache_bytes``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.tree import leaves_with_paths, unflatten

FSDP = "fsdp"
TP = "tp"
BATCH = "batch"

MESH_AXES = {
    BATCH: ("pod", "data"),
    FSDP: ("data",),
    TP: ("model",),
}

# (path-suffix, logical axes for trailing dims). The longest matching
# suffix wins.
PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings / heads
    ("embed.table", (TP, FSDP)),            # (V, D)
    ("lm_head.w", (FSDP, TP)),              # (D, V)
    ("vis_adapter.w", (None, FSDP)),
    ("frontend.w", (None, FSDP)),
    # attention
    ("mixer.wq.w", (FSDP, TP)),
    ("mixer.wk.w", (FSDP, TP)),
    ("mixer.wv.w", (FSDP, TP)),
    ("mixer.wq.b", (TP,)),
    ("mixer.wk.b", (TP,)),
    ("mixer.wv.b", (TP,)),
    ("mixer.wo.w", (TP, FSDP)),             # also MLA wo
    # MLA
    ("mixer.wq_a.w", (FSDP, None)),
    ("mixer.wq_b.w", (None, TP)),
    ("mixer.wkv_a.w", (FSDP, None)),
    ("mixer.wkv_b.w", (None, TP)),
    # MoE (E, D, F) / (E, F, D); router (D, E)
    ("mlp.router.w", (FSDP, None)),
    ("mlp.wi", (TP, FSDP, None)),
    ("mlp.wg", (TP, FSDP, None)),
    ("mlp.wo", (TP, None, FSDP)),
    # dense MLPs (covers moe "shared" too via wi.w/wg.w/wo.w)
    ("wi.w", (FSDP, TP)),
    ("wg.w", (FSDP, TP)),
    ("wo.w", (TP, FSDP)),
    ("wi.b", (TP,)),
    ("wo.b", (None,)),
    # RG-LRU
    ("mixer.proj_x.w", (FSDP, TP)),
    ("mixer.proj_gate.w", (FSDP, TP)),
    ("mixer.proj_out.w", (TP, FSDP)),
    ("mixer.conv_w", (None, TP)),
    ("mixer.conv_b", (TP,)),
    ("mixer.wa.w", (TP, None, None)),       # block-diagonal (nb, bd, bd)
    ("mixer.wa.b", (TP, None)),
    ("mixer.wi.w", (TP, None, None)),
    ("mixer.wi.b", (TP, None)),
    ("mixer.lam", (TP,)),
    # SSD
    ("mixer.in_z.w", (FSDP, TP)),
    ("mixer.in_x.w", (FSDP, TP)),
    ("mixer.in_bc.w", (FSDP, None)),
    ("mixer.in_dt.w", (FSDP, TP)),
    ("mixer.in_dt.b", (TP,)),
    ("mixer.conv_x.w", (None, TP)),
    ("mixer.conv_x.b", (TP,)),
    ("mixer.conv_bc.w", (None, None)),
    ("mixer.a_log", (TP,)),
    ("mixer.d_skip", (TP,)),
    ("mixer.dt_bias", (TP,)),
    ("mixer.norm.scale", (TP,)),
    ("mixer.out_proj.w", (TP, FSDP)),
)

CACHE_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    ("k", (BATCH, None, TP, None)),
    ("v", (BATCH, None, TP, None)),
    ("pos", (None,)),
    ("ckv", (BATCH, None, None)),
    ("krope", (BATCH, None, None)),
    ("h", (BATCH, TP)),
    ("conv", (BATCH, None, TP)),
    ("conv_x", (BATCH, None, TP)),
    ("conv_bc", (BATCH, None, None)),
    ("state", (BATCH, TP, None, None)),
)

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh without devices: its axis names and sizes (the dry run's
    production meshes, which need no 256 or 512 ranks)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def device_mesh(mesh):
    """``mesh`` itself when it is a ``DeviceMesh`` (one that runs a
    step); a ``TypeError`` for an abstract one (:class:`MeshShape`: the
    process group's world size is not the mesh's size)."""
    if not hasattr(mesh, "get_group"):
        raise TypeError(
            f"{mesh!r} has no ranks: a step needs a DeviceMesh over a "
            f"process group of its size (launch.mesh.make_host_mesh under "
            f"torch.distributed)")
    return mesh


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a :class:`MeshShape`, or
    any object with ``axis_names`` and a ``shape`` mapping (jax's
    ``Mesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def path_names(path) -> Tuple[str, ...]:
    """The dict keys of a :func:`repro_torch.tree.leaves_with_paths`
    path, list indices dropped."""
    return tuple(str(k) for k in path if not isinstance(k, int))


def _match(names: Sequence[str], rules):
    joined = ".".join(names)
    best = None
    for suffix, logical in rules:
        if joined == suffix or joined.endswith("." + suffix):
            if best is None or len(suffix) > len(best[0]):
                best = (suffix, logical)
    return None if best is None else best[1]


def resolve_spec(shape: Tuple[int, ...], logical: Sequence[Optional[str]],
                 mesh) -> Spec:
    """Map trailing-dim logical axes onto the mesh, checking
    divisibility."""
    sizes = mesh_shape(mesh)
    ndim = len(shape)
    spec: list = [None] * ndim
    used: set = set()
    offset = ndim - len(logical)
    if offset < 0:  # leaf has fewer dims than the rule: align trailing
        logical = logical[-ndim:]
        offset = 0
    for i, name in enumerate(logical):
        if name is None:
            continue
        dim = offset + i
        axes = [a for a in MESH_AXES[name] if a in sizes and a not in used]
        good: list = []
        size = 1
        for a in axes:
            if shape[dim] % (size * sizes[a]) == 0:
                good.append(a)
                size *= sizes[a]
        if good:
            used.update(good)
            spec[dim] = tuple(good) if len(good) > 1 else good[0]
    return tuple(spec)


def _tree_specs(tree, fn):
    return unflatten(tree, [fn(path, leaf)
                            for path, leaf in leaves_with_paths(tree)])


def tree_shardings(tree, mesh, rules):
    """The spec of every leaf of a tree of tensors (meta tensors
    included): the longest matching rule's, resolved on ``mesh``;
    replicated (all ``None``) where no rule matches."""

    def one(path, leaf):
        logical = _match(path_names(path), rules)
        if logical is None:
            return (None,) * leaf.ndim
        return resolve_spec(tuple(leaf.shape), logical, mesh)

    return _tree_specs(tree, one)


def batch_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    return axes if axes else None


def batch_size(mesh, axes) -> int:
    """The number of batch shards: the product of ``axes``' sizes."""
    sizes = mesh_shape(mesh)
    return math.prod(sizes[a] for a in axes or ())


def data_sharding(tree, mesh):
    """Inputs: first dim = batch, everything else replicated; scalars
    and a first dim the batch axes do not divide replicated."""
    ba = batch_axes(mesh)

    def one(_path, leaf):
        ndim = getattr(leaf, "ndim", 0)
        if ndim == 0 or ba is None:
            return (None,) * ndim
        if leaf.shape[0] % batch_size(mesh, ba) == 0:
            return (ba,) + (None,) * (ndim - 1)
        return (None,) * ndim

    return _tree_specs(tree, one)


def state_shardings(state_shapes, mesh):
    """Specs for {"params", "opt": {"m", "v", "count"}, "step"} trees: m
    and v mirror the parameters', ``count`` and ``step`` replicated."""

    def for_subtree(tree):
        return tree_shardings(tree, mesh, PARAM_RULES)

    out = {"params": for_subtree(state_shapes["params"])}
    if "opt" in state_shapes:
        out["opt"] = {"m": for_subtree(state_shapes["opt"]["m"]),
                      "v": for_subtree(state_shapes["opt"]["v"]),
                      "count": ()}
    if "step" in state_shapes:
        out["step"] = ()
    return out


def cache_shardings(cache_shapes, mesh, model: bool = True):
    """The specs of a cache tree (``CACHE_RULES``); ``model=False``: with
    "model" dropped (:func:`without_model`), as the port holds the cache
    of a mixer whose compute is gathered over "model"."""
    specs = tree_shardings(cache_shapes, mesh, CACHE_RULES)
    if model:
        return specs
    return unflatten(cache_shapes, [without_model(s)
                                    for s in spec_leaves(specs)])


# -------------------------------------------------------------- bytes --

def shard_factor(spec: Spec, mesh) -> int:
    """How many shards a leaf with ``spec`` is cut into."""
    sizes = mesh_shape(mesh)
    n = 1
    for axes in spec:
        for a in _axes(axes):
            n *= sizes[a]
    return n


def shard_bytes(leaf, spec: Spec, mesh) -> int:
    """The bytes of one device's shard of ``leaf`` (any tensor, meta
    included) placed by ``spec`` (:func:`local_shape`)."""
    return math.prod(local_shape(leaf.shape, spec, mesh)) * \
        leaf.element_size()


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a leaf of ``shape`` placed by
    ``spec`` (each dim divided by the sizes of the mesh axes named
    there; any mesh, :class:`MeshShape` included)."""
    sizes = mesh_shape(mesh)
    return tuple(n // math.prod(sizes[a] for a in _axes(entry))
                 for n, entry in zip(shape, spec))


def without_model(spec: Spec) -> Spec:
    """``spec`` with the "model" axis dropped: the placement of a leaf
    whose compute is gathered over "model", held whole on each of its
    ranks."""
    def drop(entry):
        axes = tuple(a for a in _axes(entry) if a != "model")
        return None if not axes else axes if len(axes) > 1 else axes[0]
    return tuple(drop(e) for e in spec)


def tree_shard_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of a tree placed by a tree of specs."""
    return sum(shard_bytes(t, s, mesh) for (_, t), s in zip(
        leaves_with_paths(tree), spec_leaves(specs), strict=True))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, (str, tuple)) for a in x)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_leaves(specs) -> list:
    """The specs of a spec tree in leaf order (a spec is itself a
    tuple)."""
    return [s for _, s in leaves_with_paths(specs, is_leaf=_is_spec)]


# ------------------------------------------------------------ DTensor --

def placements(spec: Spec, mesh) -> list:
    """DTensor placements on ``mesh``'s dims for ``spec``: ``Shard(d)``
    on every mesh dim named at tensor dim d (a dim on two axes, such as
    ("pod", "data"), is sharded on both, the major one first, as jax's
    ``P(("pod", "data"))``), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        dims = [names.index(a) for a in _axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {entry} are not in the "
                             f"mesh's order {names}")
        for i in dims:
            out[i] = Shard(d)
    return out


def local_shard(full: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's shard of ``full`` under ``places``, cut in mesh-dim
    order (the major axis first); a copy when it is smaller than
    ``full``, so that the full tensor can be freed."""
    from torch.distributed.tensor import Shard
    local = full
    coord = mesh.get_coordinate()
    for i, p in enumerate(places):
        if isinstance(p, Shard):
            n = mesh.size(i)
            step = local.shape[p.dim] // n
            local = local.narrow(p.dim, coord[i] * step, step)
    return local.clone() if local.numel() != full.numel() else local


def place_leaf(full: torch.Tensor, spec: Optional[Spec], mesh):
    """``full`` as a DTensor holding this rank's shard under ``spec``;
    a ``None`` spec leaves it a plain tensor (replicated on every
    rank)."""
    if spec is None:
        return full
    from torch.distributed.tensor import DTensor
    places = placements(spec, mesh)
    return DTensor.from_local(local_shard(full, mesh, places), mesh, places,
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def place(tree, specs, mesh):
    """A tree of full tensors (the same on every rank) as DTensors on
    ``mesh`` (:func:`place_leaf` per leaf; no communication)."""
    flat = spec_leaves(specs)
    return unflatten(tree, [place_leaf(t, s, mesh) for (_, t), s in zip(
        leaves_with_paths(tree), flat, strict=True)])


def placed_state_specs(state, mesh):
    """:func:`state_shardings` with ``count`` and ``step`` left plain
    tensors (``None``): the specs the sharded train step keeps."""
    specs = state_shardings(state, mesh)
    if "opt" in specs:
        specs["opt"]["count"] = None
    if "step" in specs:
        specs["step"] = None
    return specs


def place_state(state, mesh):
    """A full train state as the sharded step holds it: every leaf of
    ``params``, ``m`` and ``v`` a DTensor with the rules' placements,
    ``count`` and ``step`` plain (replicated)."""
    return place(state, placed_state_specs(state, mesh), mesh)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t):
    """A DTensor's local shard (a view of it), or ``t`` itself."""
    return t.to_local() if is_dtensor(t) else t


def full_tensor(t):
    """A DTensor gathered into its full tensor, or ``t`` itself."""
    return t.full_tensor() if is_dtensor(t) else t


def gather(tree, batch=(), partial=()):
    """Every DTensor leaf of ``tree`` as its full tensor (the rest as it
    is).  Under autograd the gradient of a gathered leaf is summed over
    the mesh dims named in ``batch`` (each batch shard's rows contribute
    their part) and cut back to the leaf's placement: a reduce-scatter
    where the leaf is sharded on a batch axis, an all-reduce where it is
    replicated there.  ``partial`` names further mesh dims whose ranks
    each hold a part of the gradient (a replicated leaf that each
    "model" rank applies to its own heads only): it is summed over them
    too."""
    from torch.distributed.tensor import Partial, Replicate
    summed = tuple(batch) + tuple(partial)

    def one(t):
        if not is_dtensor(t):
            return t
        return t.full_tensor(grad_placements=[
            Partial() if n in summed else Replicate()
            for n in t.device_mesh.mesh_dim_names])

    if isinstance(tree, dict):
        return {k: gather(v, batch, partial) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gather(v, batch, partial) for v in tree]
    return one(tree)


def model_dim(t) -> Optional[int]:
    """The tensor dim a DTensor leaf is sharded on over "model" (a mesh
    dim of size > 1), or None: a plain tensor, a mesh without "model",
    or a leaf replicated there (its spec dropped "model", or the rules
    name none)."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(t):
        return None
    names = t.device_mesh.mesh_dim_names
    if "model" not in names:
        return None
    i = names.index("model")
    p = t.placements[i]
    if t.device_mesh.size(i) == 1 or not isinstance(p, Shard):
        return None
    return p.dim


def shards_of_dim(t, dim: int) -> int:
    """Into how many shards a DTensor leaf's placement cuts its dim
    ``dim`` (1 for a plain tensor)."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(t):
        return 1
    mesh = t.device_mesh
    return math.prod(mesh.size(i) for i, p in enumerate(t.placements)
                     if isinstance(p, Shard) and p.dim == dim)


def model_shard(t, batch=()):
    """A DTensor leaf sharded over "model" (along the dim its placement
    puts there: the experts, a column-parallel matrix's output dim, a
    row-parallel one's input dim, the vocabulary), gathered over its
    other mesh dims only: this rank's "model" shard as a plain tensor.
    Its gradient is summed over the mesh dims named in ``batch`` and cut
    back to the leaf's placement (a reduce-scatter over a batch dim the
    leaf is sharded on); over "model" each rank's gradient is its own
    shard's.  A mesh dim of size 1 keeps the leaf's placement (no
    collective)."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    one = [mesh.size(i) == 1 for i in range(len(names))]
    keep = [p if n == "model" or one[i] else Replicate()
            for i, (n, p) in enumerate(zip(names, t.placements))]
    grads = [p if n == "model" or one[i] else
             Partial() if n in batch else Replicate()
             for i, (n, p) in enumerate(zip(names, t.placements))]
    if keep != list(t.placements):
        t = t.redistribute(placements=keep)
    return t.to_local(grad_placements=grads)


# -------------------------------------------------------- collectives --

def sum_over(t: torch.Tensor, mesh, axes, wide: bool = False
             ) -> torch.Tensor:
    """``t`` summed over the ranks of ``axes`` (in place, one all-reduce
    an axis of size > 1).  ``wide``: a bf16 or fp16 tensor summed in fp32
    and rounded once, as XLA:CPU promotes the reference's 16-bit
    all-reduces."""
    import torch.distributed as dist
    sizes = mesh_shape(mesh)
    for a in axes or ():
        if sizes[a] > 1:
            if wide and t.dtype in (torch.bfloat16, torch.float16):
                buf = t.float()
                dist.all_reduce(buf, group=mesh.get_group(a))
                t.copy_(buf)
            else:
                dist.all_reduce(t, group=mesh.get_group(a))
    return t


def max_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t``'s elementwise maximum over the ranks of ``axes`` (in place;
    no gradient)."""
    import torch.distributed as dist
    sizes = mesh_shape(mesh)
    for a in axes or ():
        if sizes[a] > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    return t


def barrier(mesh):
    """Waits until every rank of ``mesh`` has reached it (an all-reduce
    over each mesh dim: the ranks of the last one have passed the
    first)."""
    sum_over(torch.zeros(1, device=mesh_device(mesh)), mesh,
             mesh.mesh_dim_names)


def gather_rows(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The rows of every batch shard of ``axes``, in order (the major
    axis first), concatenated along dim 0."""
    import torch.distributed as dist
    sizes = mesh_shape(mesh)
    for a in reversed(tuple(axes or ())):
        n = sizes[a]
        if n > 1:
            out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
            dist.all_gather_into_tensor(out, t.contiguous(),
                                        group=mesh.get_group(a))
            t = out
    return t


def row_slice(mesh, axes, rows: int) -> slice:
    """This rank's rows of a batch of ``rows`` split over ``axes``."""
    sizes = mesh_shape(mesh)
    n, idx = 1, 0
    for a in axes or ():
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    step = rows // n
    return slice(idx * step, (idx + 1) * step)


class _SumOverRanks(torch.autograd.Function):
    """An all-reduce (sum) whose backward all-reduces too: for a sum
    over batch shards, each of whose ranks' losses reads it."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return sum_over(t.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g.clone(), ctx.mesh, ctx.axes), None, None


class _SumOverReplicas(torch.autograd.Function):
    """An all-reduce (sum) of partial results whose backward is the
    identity: the ranks summed compute the same loss from the sum (the
    replicas over ``model``), so each part's cotangent is the sum's."""

    @staticmethod
    def forward(ctx, t, mesh, axes, wide):
        return sum_over(t.clone(), mesh, axes, wide)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _ReplicaInput(torch.autograd.Function):
    """The identity whose backward sums the cotangent over ``axes``: an
    input every replica reads, each for its part of a result that
    :class:`_SumOverReplicas` adds up."""

    @staticmethod
    def forward(ctx, t, mesh, axes, wide):
        ctx.mesh, ctx.axes, ctx.wide = mesh, axes, wide
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g.clone(), ctx.mesh, ctx.axes, ctx.wide), None, \
            None, None


def sum_over_batch(t, mesh, axes):
    return _SumOverRanks.apply(t, mesh, tuple(axes or ()))


def sum_over_replicas(t, mesh, axes, wide: bool = False):
    """The conjugate pair's sum (forward all-reduce, backward identity);
    ``wide`` as :func:`sum_over`'s."""
    return _SumOverReplicas.apply(t, mesh, tuple(axes), wide)


def replica_input(t, mesh, axes, wide: bool = False):
    """The conjugate pair's input (forward identity, backward
    all-reduce); ``wide`` as :func:`sum_over`'s."""
    return _ReplicaInput.apply(t, mesh, tuple(axes), wide)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A block's tensor-parallel compute over the mesh's "model" axis
    (Megatron's conjugate pair, :func:`replica_input` and
    :func:`sum_over_replicas`): each rank holds its "model" shard of the
    block's column-parallel matrices (output dim) and row-parallel ones
    (input dim); an input every rank reads whole is marked with
    :meth:`input` (its cotangent summed over "model" in the backward),
    and a row-parallel product's partial result is summed over "model"
    with :meth:`sum`, in the partial's dtype (bf16 summed in fp32 and
    rounded once: :func:`sum_over`)."""
    mesh: Any

    @property
    def size(self) -> int:
        return mesh_shape(self.mesh)["model"]

    @property
    def rank(self) -> int:
        return self.mesh.get_local_rank("model")

    def input(self, t):
        return replica_input(t, self.mesh, ("model",), wide=True)

    def sum(self, t):
        return sum_over_replicas(t, self.mesh, ("model",), wide=True)

    def max(self, t):
        """The elementwise maximum over "model" of a tensor that carries
        no gradient."""
        return max_over(t.detach().clone(), self.mesh, ("model",))

    def gather(self, t):
        """Every "model" rank's ``t`` (the same shape on each) joined
        along the last dim in rank order, in ``t``'s dtype (one
        all-gather; no gradient): a column-parallel product's columns
        made whole."""
        import torch.distributed as dist
        n = self.size
        out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.detach().contiguous(),
                                    group=self.mesh.get_group("model"))
        return out.reshape(n, *t.shape).movedim(0, -2).reshape(
            *t.shape[:-1], n * t.shape[-1])


def tensor_parallel(mesh) -> Optional[TensorParallel]:
    """:class:`TensorParallel` on ``mesh`` when its "model" axis has more
    than one rank, else None."""
    if mesh is None or mesh_shape(mesh).get("model", 1) == 1:
        return None
    return TensorParallel(device_mesh(mesh))


def mesh_device(mesh) -> torch.device:
    """The device a mesh's rank computes on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
