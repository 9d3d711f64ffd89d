"""Mesh construction over torch.distributed: one process is one rank.

Counterpart of ``seldon_core_tpu/parallel/mesh.py``. JAX runs one
controller over N devices and names them by a device array; here every
rank runs the same program and a :class:`Mesh` tells it where it sits:
the ordered axis sizes (``data``, ``stage``, ``seq``, ``model``), its own
coordinates, and one process group per axis plus the combined
``("data", "seq")`` group that expert parallelism rides. Ranks map to
coordinates row-major in the dict's order, as ``make_mesh`` reshapes
``jax.devices()``, so rank r holds exactly the shard that JAX device r
holds.

Backends: NCCL on ``cuda:<local rank>`` (the default), gloo with CPU
tensors for the tests. The pure-Python helpers (:func:`factor_devices`,
:func:`parse_mesh_shape`, :func:`validate_model_dims`) are copies of the
JAX package's, with the same messages.

Sharded generate serving runs one controller over N devices, as the JAX
serving mesh does: a :class:`ServingMesh` names a device per position,
a :class:`ServingSharding` says which dimension splits over which axis,
and a :class:`ShardedTensor` holds a tensor's blocks on their devices
(:func:`place` puts a tensor there). The batcher and ``DecoderLM``
store params and the KV cache so and compute on the mesh's first device
(``DecoderLM.set_serving_mesh``).
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

AXES = ("data", "stage", "seq", "model")
# the axes expert parallelism rides, data-major
EP_AXES = ("data", "seq")

AxisNames = Union[str, Sequence[str]]


class MeshShapeError(ValueError):
    """A mesh shape that cannot be built or cannot shard the model.

    Raised by :func:`make_mesh` / :func:`parse_mesh_shape` /
    :func:`validate_model_dims` instead of letting a collective fail later
    with an opaque shape error. Subclasses ``ValueError`` so existing
    ``except ValueError`` admission paths keep refusing bad shapes."""


def factor_devices(n: int) -> Dict[str, int]:
    """Factor n devices into (data, stage, seq, model) prioritising: tp,
    then pp, then dp, then sp. All five strategies stay *wired* at any n
    (expert parallelism rides data x seq); axes degrade to 1 when chips run
    out. 8 chips -> {data:2, stage:2, seq:1, model:2}; 16 -> all 2;
    32 -> model 4.
    """
    if not isinstance(n, int) or n < 1:
        raise MeshShapeError(f"cannot factor {n!r} devices: need a positive int")
    axes = {"data": 1, "stage": 1, "seq": 1, "model": 1}
    order = ["model", "stage", "data", "seq"]
    i = 0
    while n > 1:
        axis = order[i % len(order)]
        if n % 2 == 0:
            axes[axis] *= 2
            n //= 2
        else:  # odd remainder goes to data
            axes["data"] *= n
            n = 1
        i += 1
    return axes


def parse_mesh_shape(raw: str) -> Dict[str, int]:
    """Parse ``"data=2,model=4"`` into an ordered ``{axis: size}`` dict.

    Strict by design — this is the admission-time parser behind the
    ``seldon.io/mesh`` annotation and the ``mesh_shape`` server knob, so
    every malformed input gets a typed :class:`MeshShapeError` naming the
    offending fragment instead of an opaque downstream failure. Accepted
    axis names are the house mesh axes (data/stage/seq/model); duplicate
    axes and non-positive sizes are refused."""
    if not isinstance(raw, str) or not raw.strip():
        raise MeshShapeError(f"mesh shape {raw!r}: expected 'axis=N,axis=N'")
    allowed = AXES
    shape: Dict[str, int] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            raise MeshShapeError(f"mesh shape {raw!r}: empty segment")
        if "=" not in part:
            raise MeshShapeError(
                f"mesh shape segment {part!r}: expected 'axis=N'"
            )
        ax, _, val = part.partition("=")
        ax = ax.strip()
        if ax not in allowed:
            raise MeshShapeError(
                f"mesh axis {ax!r}: must be one of {allowed}"
            )
        if ax in shape:
            raise MeshShapeError(f"mesh axis {ax!r} given twice in {raw!r}")
        try:
            size = int(val.strip())
        except ValueError:
            raise MeshShapeError(
                f"mesh axis {ax!r}={val.strip()!r}: size must be an int"
            ) from None
        if size < 1:
            raise MeshShapeError(
                f"mesh axis {ax!r}={size}: sizes must be positive"
            )
        shape[ax] = size
    return shape


def validate_model_dims(
    shape: Dict[str, int],
    n_heads: int,
    d_ff: int,
    n_kv_heads: Optional[int] = None,
) -> None:
    """Reject a mesh whose ``model`` axis cannot shard the hard-split
    dims. Attention heads and the FFN hidden dim are partitioned (not
    replicated) under the TP layout, so ``model`` must divide both. KV
    heads are allowed to be indivisible (GQA targets / thin drafts): the
    cache layer replicates them instead, so that is NOT an error here."""
    tp = int(shape.get("model", 1))
    if tp <= 1:
        return
    if n_heads % tp != 0:
        raise MeshShapeError(
            f"mesh model={tp} does not divide n_heads={n_heads}; "
            "attention heads are hard-sharded over the model axis"
        )
    if d_ff % tp != 0:
        raise MeshShapeError(
            f"mesh model={tp} does not divide d_ff={d_ff}; "
            "the FFN hidden dim is hard-sharded over the model axis"
        )
    del n_kv_heads  # indivisible KV heads replicate — see cache_sharding


def _check_shape(shape: Dict[str, int], world: Optional[int] = None) -> int:
    """``make_mesh``'s refusals (JAX mesh.py:63-82): the sizes, then, given
    ``world``, the mesh against that many ranks. Returns the mesh's rank
    count."""
    total = 1
    for ax, s in shape.items():
        if not isinstance(s, int) or s < 1:
            raise MeshShapeError(
                f"mesh axis {ax!r}={s!r}: sizes must be positive ints"
            )
        total *= s
    if world is None:
        return total
    if total > world:
        raise MeshShapeError(f"mesh {shape} needs {total} devices, have {world}")
    if world % total != 0:
        # a non-dividing shape would strand the remainder ranks outside
        # the mesh — surface the mistake here with the arithmetic spelled out
        raise MeshShapeError(
            f"mesh {shape} covers {total} of {world} devices; "
            f"{total} does not divide {world} — the leftover "
            f"{world % total} chip(s) would idle"
        )
    return total


class Axis:
    """One mesh axis, or a tuple of axes taken together, as this rank
    sees it: ``size``, this rank's ``index`` along it (the linear index,
    first axis major, for a tuple: JAX's ``axis_index`` over the tuple),
    ``members`` (the global ranks of this rank's line, in index order)
    and the process ``group`` of that line (None at size 1, where every
    collective is the identity). ``parts`` holds the single axes of a
    tuple that has no group of its own; collectives then run axis by
    axis."""

    def __init__(self, names: Tuple[str, ...], size: int, index: int,
                 members: List[int], group=None, parts: Tuple["Axis", ...] = ()):
        self.names = names
        self.size = size
        self.index = index
        self.members = members
        self.group = group
        self.parts = parts
        # group rank of the member at each index: torch numbers a group's
        # ranks in ascending global order, which may differ from the
        # mesh's index order (a hybrid mesh with DCN axes first)
        order = sorted(members)
        self.group_pos = [order.index(m) for m in members]

    def __repr__(self) -> str:
        return f"Axis({self.names}, size={self.size}, index={self.index})"


class Mesh:
    """The mesh of the initialised process group, seen from this rank.

    ``ranks`` is the array of global ranks in mesh coordinates (shape =
    the axis sizes in ``axis_names`` order), as JAX's ``Mesh.devices``.
    ``shape`` maps every house axis (``data``, ``stage``, ``seq``,
    ``model``) to its size, 1 for an axis the caller left out.
    ``coords`` is this rank's coordinate per axis, or None for a rank
    outside the mesh (the world may hold a multiple of the mesh)."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str], rank: int):
        import torch.distributed as dist

        self.axis_names = tuple(axis_names)
        self.ranks = np.asarray(ranks)
        self.rank = rank
        self.shape = {ax: 1 for ax in AXES}
        self.shape.update({ax: int(s) for ax, s in zip(self.axis_names, self.ranks.shape)})
        where = np.argwhere(self.ranks == rank)
        self.coords = ({ax: int(c) for ax, c in zip(self.axis_names, where[0])}
                       if len(where) else None)
        if self.coords is not None:
            for ax in AXES:
                self.coords.setdefault(ax, 0)
        self._axes: Dict[Tuple[str, ...], Axis] = {}
        # every rank creates every group, in one order: new_group is
        # collective over the world. A tuple with one axis above 1 reuses
        # that axis's group.
        for names in [(ax,) for ax in AXES] + [EP_AXES]:
            lines = self._lines(names)
            wide = [n for n in names if self.shape[n] > 1]
            group = None
            if len(wide) > 1 or len(names) == 1 and wide:
                for line in lines:
                    g = dist.new_group(sorted(line))
                    if rank in line:
                        group = g
            elif wide and self.coords is not None:
                group = self._axes[(wide[0],)].group
            self._register(names, lines, group)

    def _lines(self, names: Tuple[str, ...]) -> List[List[int]]:
        """Every line of global ranks along ``names`` (index order, first
        name major), one per coordinate of the other axes."""
        pos = [self.axis_names.index(n) for n in names if n in self.axis_names]
        rest = [i for i in range(self.ranks.ndim) if i not in pos]
        width = int(np.prod([self.ranks.shape[p] for p in pos]))
        arr = np.transpose(self.ranks, rest + pos).reshape(-1, width)
        return [[int(r) for r in line] for line in arr]

    def _register(self, names, lines, group, parts=()) -> None:
        line = next((l for l in lines if self.rank in l), None)
        if line is not None:  # None: a rank outside the mesh
            self._axes[names] = Axis(names, len(line), line.index(self.rank), line,
                                     group, parts)

    def axis(self, names: AxisNames) -> Axis:
        """The :class:`Axis` of one axis name or a tuple of names."""
        names = (names,) if isinstance(names, str) else tuple(names)
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} lies outside the mesh {self.shape}")
        if names not in self._axes:  # a tuple without a group: axis by axis
            parts = tuple(self._axes[(n,)] for n in names)
            self._register(names, self._lines(names), None, parts)
        return self._axes[names]

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.ranks.shape))}, rank={self.rank})"


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no process group: call initialize_distributed() (or "
            "torch.distributed.init_process_group) before building a mesh"
        )
    return dist.get_world_size(), dist.get_rank()


def make_mesh(shape: Dict[str, int]) -> Mesh:
    """Build the :class:`Mesh` with named axes from ``{axis: size}`` over
    the initialised process group.

    Axis order follows the dict order; put the slowest-varying
    (cross-node) axis first so that NVLink carries the tp/sp collectives.
    Refuses a size that is not a positive int, a mesh larger than the
    world, and one whose size does not divide it (JAX mesh.py:63-82). A
    world that holds a multiple of the mesh uses its first ranks, as JAX
    uses the first devices. An axis outside data/stage/seq/model is
    refused: the JAX mesh takes any name, the port's training step knows
    these four."""
    shape = dict(shape)
    for ax in shape:
        if ax not in AXES:
            raise MeshShapeError(f"mesh axis {ax!r}: must be one of {AXES}")
    _check_shape(shape)  # sizes first, before any process group is asked
    world, rank = _world()
    total = _check_shape(shape, world)
    ranks = np.arange(total).reshape(tuple(shape.values()))
    return Mesh(ranks, tuple(shape.keys()), rank)


def make_hybrid_mesh(ici_shape: Dict[str, int],
                     dcn_shape: Optional[Dict[str, int]] = None) -> Mesh:
    """Mesh spanning nodes: ``dcn_shape`` axes (typically data and/or
    stage — gradient and activation hops that tolerate the network)
    partition BETWEEN nodes, ``ici_shape`` axes (model/seq — the
    latency-critical tp/sp collectives) partition WITHIN a node of
    ``LOCAL_WORLD_SIZE`` ranks (the torchrun variable; one node when it
    is unset).

    Falls back to a flat :func:`make_mesh` on one node, or when no axis
    crosses nodes — same axis names, so callers never branch. Across
    nodes a rank's coordinate on each axis is its node's coordinate times
    the axis's per-node size plus its coordinate within the node, as
    ``mesh_utils.create_hybrid_device_mesh`` lays slices out."""
    dcn_shape = dict(dcn_shape or {})
    world, rank = _world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_nodes = world // max(1, local)
    dcn_total = int(np.prod(list(dcn_shape.values()) or [1]))
    if n_nodes <= 1 or dcn_total <= 1:
        merged = {**dcn_shape, **ici_shape}
        for ax, size in dcn_shape.items():
            if ax in ici_shape:
                merged[ax] = ici_shape[ax] * size
        return make_mesh(merged)
    axis_names = list(dcn_shape.keys()) + [ax for ax in ici_shape if ax not in dcn_shape]
    per_node = [ici_shape.get(ax, 1) for ax in axis_names]
    across = [dcn_shape.get(ax, 1) for ax in axis_names]
    for ax in axis_names:
        _check_shape({ax: ici_shape.get(ax, 1) * dcn_shape.get(ax, 1)})
    if int(np.prod(per_node)) != local or int(np.prod(across)) != n_nodes:
        raise MeshShapeError(
            f"hybrid mesh ici {ici_shape} x dcn {dcn_shape} needs "
            f"{int(np.prod(per_node))} ranks per node on {int(np.prod(across))} "
            f"nodes, have {local} per node on {n_nodes}"
        )
    ranks = np.empty([i * d for i, d in zip(per_node, across)], dtype=np.int64)
    for node_c in itertools.product(*[range(d) for d in across]):
        node = int(np.ravel_multi_index(node_c, across)) if across else 0
        for local_c in itertools.product(*[range(i) for i in per_node]):
            local_r = int(np.ravel_multi_index(local_c, per_node)) if per_node else 0
            at = tuple(n * p + c for n, p, c in zip(node_c, per_node, local_c))
            ranks[at] = node * local + local_r
    return Mesh(ranks, axis_names, rank)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> bool:
    """Join this process into the process group.

    The coordinator is ``coordinator_address``, else
    ``SELDON_TPU_COORDINATOR``, else torchrun's ``MASTER_ADDR`` (read as
    ``env://``). A coordinator without a scheme is ``tcp://host:port``;
    ``file:///path`` rendezvouses through a file. The world size is
    ``num_processes``, else ``SELDON_TPU_NUM_PROCESSES``, else
    ``WORLD_SIZE``; the rank is ``process_id``, else
    ``SELDON_TPU_PROCESS_ID``, else ``RANK``.

    Returns False with no coordinator (a single process that asked for
    no group) and when the group is already initialised; True after
    joining. Every other failure raises: a process that was asked to
    join and could not never continues alone. Under ``nccl`` (the
    default) this rank's card is ``cuda:<LOCAL_RANK>`` (else the rank
    modulo the cards), made current here; without CUDA it raises."""
    import torch
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("SELDON_TPU_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = "env://"
    if num_processes is None:
        env = os.environ.get("SELDON_TPU_NUM_PROCESSES", os.environ.get("WORLD_SIZE"))
        num_processes = int(env) if env is not None else None
    if process_id is None:
        env = os.environ.get("SELDON_TPU_PROCESS_ID", os.environ.get("RANK"))
        process_id = int(env) if env is not None else None
    if coordinator_address is None:
        return False
    if dist.is_initialized():
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address!r} given without a world size "
            "and a rank: set SELDON_TPU_NUM_PROCESSES and SELDON_TPU_PROCESS_ID "
            "(or WORLD_SIZE and RANK)"
        )
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    if backend == "nccl":
        from ..device import resolve_device

        resolve_device("cuda")  # raises without CUDA
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True


# ---------------------------------------------------------------------------
# the serving mesh: one process over N devices
# ---------------------------------------------------------------------------

# The positions a CPU mesh may hold: the CPU stands in for this many
# devices, as the tests' JAX backend stands in for 8 virtual devices
# (``--xla_force_host_platform_device_count=8``).
CPU_DEVICE_COUNT = 8


class ServingMesh:
    """The device mesh of sharded generate serving, held by ONE process
    (the JAX serving mesh is single-controller too; :class:`Mesh` is the
    training step's one-process-a-rank view).

    ``shape`` maps each named axis, in order, to its size (``data``,
    ``model``, and ``seq`` when the cache length is sharded);
    ``axis_names`` is that order, ``size`` the product. ``devices`` holds
    one ``torch.device`` per position, row-major in ``axis_names`` order
    as ``make_mesh`` reshapes ``jax.devices()``; ``device`` is the first,
    where the replicated compute runs. Several positions may name one
    device: the tests and the on-card smoke run map every position onto
    one CPU or one card. :func:`make_serving_mesh` never does."""

    def __init__(self, shape: Dict[str, int], devices: Sequence):
        import torch

        shape = dict(shape)
        for ax in shape:
            if ax not in AXES:
                raise MeshShapeError(f"mesh axis {ax!r}: must be one of {AXES}")
        total = _check_shape(shape)
        devices = [torch.device(d) for d in devices]
        if len(devices) != total:
            raise MeshShapeError(
                f"mesh {shape} has {total} positions, got {len(devices)} devices")
        self.shape = shape
        self.axis_names = tuple(shape)
        self.size = total
        self.devices = devices
        self.device = devices[0]

    def coords(self, position: int) -> Dict[str, int]:
        """The axis coordinates of a position (row-major)."""
        sizes = [self.shape[ax] for ax in self.axis_names]
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(position, sizes))))

    def distinct_devices(self) -> List:
        out: List = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        devs = ",".join(str(d) for d in self.distinct_devices())
        return f"ServingMesh({self.shape}, devices=[{devs}])"


def serving_device_count(device="cuda") -> int:
    """Devices a serving mesh on ``device``'s type can span: the visible
    cards for CUDA, :data:`CPU_DEVICE_COUNT` positions for the CPU."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else CPU_DEVICE_COUNT


def make_serving_mesh(shape: Dict[str, int], device="cuda",
                      devices: Optional[Sequence] = None) -> ServingMesh:
    """Build the :class:`ServingMesh` of ``{axis: size}``: over ``devices``
    when given (a control-plane placement block), else over the visible
    cards ``cuda:0..N-1`` (``device`` of type cuda) or the CPU's
    :data:`CPU_DEVICE_COUNT` positions (``device`` "cpu").

    The JAX ``make_mesh`` refusals, with its messages: a size that is not
    a positive int, more positions than devices, and a size that does not
    divide the device count (the rest would idle). The mesh takes the
    first devices. Between two distinct cards the gathers and re-slices
    copy card to card inside the decode bursts' CUDA graphs, which needs
    peer access: a mesh over cards without it is refused."""
    import torch

    from ..device import resolve_device

    shape = dict(shape)
    for ax in shape:
        if ax not in AXES:
            raise MeshShapeError(f"mesh axis {ax!r}: must be one of {AXES}")
    total = _check_shape(shape)
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device("cpu")] * CPU_DEVICE_COUNT
    devices = [torch.device(d) for d in devices]
    if total > len(devices):
        raise MeshShapeError(f"mesh {shape} needs {total} devices, have {len(devices)}")
    if len(devices) % total != 0:
        raise MeshShapeError(
            f"mesh {shape} covers {total} of {len(devices)} devices; "
            f"{total} does not divide {len(devices)} — the leftover "
            f"{len(devices) % total} chip(s) would idle"
        )
    mesh = ServingMesh(shape, devices[:total])
    cards = [d for d in mesh.distinct_devices() if d.type == "cuda"]
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a.index, b.index):
                raise MeshShapeError(
                    f"mesh {shape}: {a} cannot access {b} directly (no peer "
                    "access); the serving mesh copies between its cards inside "
                    "CUDA graphs and needs it"
                )
    return mesh


class ServingSharding:
    """Which tensor dimension splits over which mesh axis: the port's
    ``NamedSharding(mesh, PartitionSpec(*spec))``. ``spec[d]`` is an axis
    name or None; dimensions past the spec are replicated (``()`` is
    fully replicated, as ``P()``)."""

    def __init__(self, mesh: ServingMesh, spec: Sequence[Optional[str]] = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def split_dims(self) -> Dict[int, str]:
        """``{dim: axis}`` of the dimensions that really split (axis size
        above 1)."""
        return {d: ax for d, ax in enumerate(self.spec)
                if ax is not None and self.mesh.shape.get(ax, 1) > 1}

    @property
    def is_fully_replicated(self) -> bool:
        return not self.split_dims()

    def check_divides(self, shape: Sequence[int]) -> None:
        """Raise :class:`MeshShapeError` (a ``ValueError``) unless every
        split dimension of ``shape`` divides over its axis, as
        ``jax.device_put`` refuses an array that does not tile its
        ``NamedSharding``."""
        for d, ax in self.split_dims().items():
            if shape[d] % self.mesh.shape[ax]:
                raise MeshShapeError(
                    f"dimension {d} of {tuple(shape)} does not divide over "
                    f"{ax}={self.mesh.shape[ax]}")

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        for d, ax in self.split_dims().items():
            out[d] //= self.mesh.shape[ax]
        return tuple(out)

    def __eq__(self, other) -> bool:
        return (isinstance(other, ServingSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def __repr__(self) -> str:
        return f"ServingSharding({self.spec})"


class _Block:
    __slots__ = ("index", "region", "device", "tensor")

    def __init__(self, index, region, device, tensor):
        self.index = index  # block coordinate per split dim
        self.region = region  # {dim: (lo, hi)} of the split dims
        self.device = device
        self.tensor = tensor


class ShardedTensor:
    """A tensor stored in blocks over a :class:`ServingMesh`: each split
    dimension cut into ``torch.chunk``-sized pieces, each piece held on
    the device of every mesh position that owns it (replicated over the
    axes that do not split it; two positions on one device share one
    block). Nothing computes on it: reads gather blocks into a tensor on
    the mesh's compute device (``read_into``, ``[...]``) and writes
    re-slice a tensor into every block that holds the region
    (``write_from``, ``[...] =``). Both are copies only, so the numbers
    are the unsharded tensor's exactly."""

    def __init__(self, shape, dtype, sharding: ServingSharding, blocks: List[_Block],
                 split: Dict[int, str]):
        import torch

        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.mesh = sharding.mesh
        self.device = self.mesh.device
        self._blocks = blocks
        self._split = split
        # the block each region is read from: the compute device's copy
        # when it has one, else the first position's
        self._primary: Dict[tuple, _Block] = {}
        for b in blocks:
            cur = self._primary.get(b.index)
            if cur is None or (cur.device != self.device and b.device == self.device):
                self._primary[b.index] = b

    # -- construction -------------------------------------------------------

    @staticmethod
    def _layout(shape, sharding: ServingSharding):
        """``[(index, region, device)]`` of every distinct block, in mesh
        position order, and the split dims."""
        sharding.check_divides(shape)
        split = sharding.split_dims()
        mesh = sharding.mesh
        seen, out = set(), []
        for pos, dev in enumerate(mesh.devices):
            c = mesh.coords(pos)
            index = tuple(c[ax] for _d, ax in sorted(split.items()))
            if (index, dev) in seen:
                continue
            seen.add((index, dev))
            region = {}
            for d, ax in split.items():
                n = shape[d] // mesh.shape[ax]
                region[d] = (c[ax] * n, (c[ax] + 1) * n)
            out.append((index, region, dev))
        return out, split

    @classmethod
    def zeros(cls, shape, dtype, sharding: ServingSharding) -> "ShardedTensor":
        """A zeroed sharded tensor, allocated block by block (the whole
        tensor never exists in one place)."""
        import torch

        layout, split = cls._layout(shape, sharding)
        blocks = []
        for index, region, dev in layout:
            bshape = list(shape)
            for d, (lo, hi) in region.items():
                bshape[d] = hi - lo
            blocks.append(_Block(index, region, dev, torch.zeros(bshape, dtype=dtype, device=dev)))
        return cls(shape, dtype, sharding, blocks, split)

    @classmethod
    def from_tensor(cls, t, sharding: ServingSharding) -> "ShardedTensor":
        """``t`` cut into its blocks, each a copy on its device."""
        layout, split = cls._layout(t.shape, sharding)
        blocks = []
        for index, region, dev in layout:
            piece = t
            for d, (lo, hi) in region.items():
                piece = piece.narrow(d, lo, hi - lo)
            blocks.append(_Block(index, region, dev,
                                 piece.to(dev, copy=True).contiguous()))
        return cls(t.shape, t.dtype, sharding, blocks, split)

    # -- tensor-like surface ------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return self.shape.numel()

    def element_size(self) -> int:
        return self._blocks[0].tensor.element_size()

    @property
    def nbytes(self) -> int:
        """Global bytes, as a sharded JAX array's ``.nbytes``."""
        return self.numel() * self.element_size()

    @property
    def shard_nbytes(self) -> int:
        """Bytes one mesh position holds."""
        n = self.element_size()
        for s in self.sharding.shard_shape(self.shape):
            n *= s
        return n

    def to(self, dtype) -> "ShardedTensor":
        """A copy in ``dtype``, cast block by block (the whole tensor never
        exists in one place); ``self`` when it already has that dtype."""
        if dtype == self.dtype:
            return self
        blocks = [_Block(b.index, b.region, b.device, b.tensor.to(dtype))
                  for b in self._blocks]
        return ShardedTensor(self.shape, dtype, self.sharding, blocks, self._split)

    def blocks(self) -> List[Tuple[Any, Any]]:
        """``[(device, tensor)]`` of every stored block."""
        return [(b.device, b.tensor) for b in self._blocks]

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, blocks={len(self._blocks)})")

    # -- indexing -----------------------------------------------------------

    def _norm_key(self, key) -> Optional[list]:
        import torch

        if not isinstance(key, tuple):
            key = (key,)
        if len(key) > self.ndim or any(e is Ellipsis or e is None for e in key):
            return None
        key = list(key) + [slice(None)] * (self.ndim - len(key))
        n_adv = 0
        for i, e in enumerate(key):
            if isinstance(e, (list, np.ndarray)):
                key[i] = e = torch.as_tensor(e)
            if isinstance(e, torch.Tensor):
                if e.dim() != 1 or e.dtype == torch.bool:
                    return None
                n_adv += 1
            elif isinstance(e, slice):
                if e.step not in (None, 1):
                    return None
            elif not isinstance(e, int):
                return None
        return key if n_adv <= 1 else None

    def _out_shape(self, key) -> List[int]:
        out = []
        for d, e in enumerate(key):
            if isinstance(e, slice):
                out.append(len(range(*e.indices(self.shape[d]))))
            elif not isinstance(e, int):
                out.append(int(e.numel()))
        return out

    def _plan(self, key, blocks):
        """Per block: its local key, and ``{out dim: (lo, hi)}`` of the
        indexed result that it covers; blocks the key misses are left
        out."""
        import torch

        out_dim, o = {}, 0
        for d, e in enumerate(key):
            if not isinstance(e, int):
                out_dim[d] = o
                o += 1
        for e_d, e in enumerate(key):
            if isinstance(e, torch.Tensor) and e_d in self._split:
                return None
        plans = []
        for b in blocks:
            local, ranges, hit = list(key), {}, True
            for d in self._split:
                lo, hi = b.region[d]
                e = key[d]
                if isinstance(e, slice):
                    s, t, _ = e.indices(self.shape[d])
                    a, z = max(s, lo), min(t, hi)
                    if a >= z:
                        hit = False
                        break
                    local[d] = slice(a - lo, z - lo)
                    ranges[out_dim[d]] = (a - s, z - s)
                else:
                    i = e % self.shape[d]
                    if not lo <= i < hi:
                        hit = False
                        break
                    local[d] = i - lo
            if not hit:
                continue
            for d, e in enumerate(local):
                if isinstance(e, torch.Tensor) and e.device != b.device:
                    local[d] = e.to(b.device)
            plans.append((b, tuple(local), ranges))
        return plans

    @staticmethod
    def _narrow(t, ranges):
        for od, (a, z) in ranges.items():
            t = t.narrow(od, a, z - a)
        return t

    def full(self):
        """The whole tensor, gathered onto the compute device."""
        import torch

        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        self.read_into(out, ())
        return out

    def read_into(self, out, key=()) -> None:
        """``out.copy_(self[key])`` without materialising the rest:
        ``out`` has the indexed shape (any strides)."""
        k = self._norm_key(key)
        plans = None if k is None else self._plan(k, self._primary.values())
        if plans is None:
            out.copy_(self.full()[key])
            return
        for b, local, ranges in plans:
            self._narrow(out, ranges).copy_(b.tensor[local])

    def write_from(self, src, key=()) -> None:
        """``self[key] = src`` into every block holding the region."""
        import torch

        if isinstance(src, ShardedTensor):
            src = src.full()
        k = self._norm_key(key)
        plans = None if k is None else self._plan(k, self._blocks)
        if plans is None:
            whole = self.full()
            whole[key] = src
            self.write_from(whole, ())
            return
        src = torch.as_tensor(src, dtype=self.dtype, device=self.device)
        src = src.expand(self._out_shape(k))
        for b, local, ranges in plans:
            piece = self._narrow(src, ranges)
            if piece.device != b.device:
                piece = piece.to(b.device)
            b.tensor[local] = piece

    def __getitem__(self, key):
        import torch

        k = self._norm_key(key)
        if k is None:
            return self.full()[key]
        out = torch.empty(self._out_shape(k), dtype=self.dtype, device=self.device)
        self.read_into(out, key)
        return out

    def __setitem__(self, key, value) -> None:
        self.write_from(value, key)

    def copy_(self, src) -> "ShardedTensor":
        if isinstance(src, ShardedTensor) and src.sharding == self.sharding:
            for b, s in zip(self._blocks, src._blocks):
                b.tensor.copy_(s.tensor)
        else:
            self.write_from(src, ())
        return self

    def narrow(self, dim: int, start: int, length: int) -> "ShardedTensor":
        """A view of ``[start, start + length)`` along an unsplit ``dim``:
        writes through it land in this tensor's blocks."""
        if dim in self._split:
            raise ValueError(f"narrow along split dimension {dim}")
        shape = list(self.shape)
        shape[dim] = length
        blocks = [_Block(b.index, b.region, b.device, b.tensor.narrow(dim, start, length))
                  for b in self._blocks]
        return ShardedTensor(shape, self.dtype, self.sharding, blocks, self._split)


def place(t, sharding: Optional[ServingSharding]):
    """Put a tensor under a sharding: a :class:`ShardedTensor` when some
    dimension really splits, else the tensor itself on the mesh's compute
    device (a replicated leaf is read on that device only, so it is kept
    there once). An already-placed tensor of that sharding is returned as
    it is; ``sharding`` None returns ``t``."""
    if sharding is None:
        return t
    if isinstance(t, ShardedTensor):
        if t.sharding == sharding:
            return t
        t = t.full()
    if sharding.is_fully_replicated:
        return t.to(sharding.mesh.device)
    return ShardedTensor.from_tensor(t, sharding)


def place_tree(tree, shardings):
    """:func:`place` over nested dicts and lists, leaf for leaf with
    ``shardings`` (the same structure)."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [place_tree(v, s) for v, s in zip(tree, shardings)]
    return place(tree, shardings)


def tree_shard_bytes(tree) -> int:
    """Bytes one mesh position holds of a placed tree (nested dicts and
    lists; a plain tensor counts whole)."""
    if isinstance(tree, dict):
        return sum(tree_shard_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_shard_bytes(v) for v in tree)
    if isinstance(tree, ShardedTensor):
        return tree.shard_nbytes
    if hasattr(tree, "element_size"):
        return tree.numel() * tree.element_size()
    return 0
