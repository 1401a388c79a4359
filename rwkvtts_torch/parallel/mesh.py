"""Device mesh, sharding rules and the collectives of the multi-rank paths
(counterpart of rwkvtts_tpu/parallel/mesh.py).

A mesh is (dp, fsdp, tp) or, with sequence parallelism, (dp, fsdp, tp, sp)
over the ranks of the ``torch.distributed`` process group, in JAX's axis
order (rank = ((d * fsdp + f) * tp + t) * sp + s):

  dp    data parallel: the batch rows split over it
  fsdp  ZeRO-style sharding: the f32 masters and the optimizer state of the
        leaves ``param_specs`` names are split along one dimension; the
        batch rows split over it too
  tp    tensor parallelism: its rules are kept, the axis must be 1 (not
        ported yet)
  sp    sequence parallelism: the time axis of every (B, T, ...) batch leaf
        splits over it; the WKV recurrence composes per-span transfer
        operators across the ranks (ops/wkv7.wkv7_spans) and the token
        shift reads the previous rank's last row (``sp_prev_row``)

Unlike JAX, which takes the first n devices, the mesh must hold every rank:
a torch rank cannot sit outside it. The collectives are explicit (GSPMD
inserts JAX's): ``Mesh.all_gather`` / ``reduce_scatter`` / ``all_reduce``
over an axis or over every rank, and the differentiable ``AllGather`` of
the sp paths. Gloo takes the four on CUDA tensors (only send / recv it
refuses there, and nothing here uses them), so several gloo ranks can share
one card. Without a process group the mesh is ``Local``: one rank, every
collective the identity.

While a train step runs its loss, the step's mesh is the ``current()`` one:
the loss denominators (ops/loss.py, codecs/flow.py) and the sp paths of the
model read it. Outside a step there is none and every op is the
single-device one.
"""
from __future__ import annotations

import contextlib
import re
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from rwkvtts_torch.train.optimizer import flatten, unflatten

AXES = ("dp", "fsdp", "tp", "sp")

# with "on", every collective of a Mesh is timed between two device
# synchronisations (which serialise it with the compute): "s" seconds over
# "calls" collectives
timing = {"on": False, "s": 0.0, "calls": 0}

# Param-path -> spec rules, JAX's: a spec is a tuple with one entry a
# dimension, each None (replicated), an axis name, or a tuple of names.
# Block leaves carry a leading stacked-layer axis. First match wins.
_RULES: Tuple[Tuple[str, tuple], ...] = (
    # block matrices (L, in, out): column-parallel on tp, fsdp on the input dim
    (r"blocks/att/(receptance|key|value)$", (None, "fsdp", "tp")),
    (r"blocks/att/output$", (None, "tp", "fsdp")),
    (r"blocks/ffn/key$", (None, "fsdp", "tp")),
    (r"blocks/ffn/value$", (None, "tp", "fsdp")),
    # LoRA factors: the wide side on tp only
    (r"blocks/att/(w1|a1|v1|g1)$", (None, None, "tp")),
    (r"blocks/att/(w2|a2|v2|g2)$", (None, "tp", None)),
    # embeddings / heads: the vocab dim on (fsdp, tp)
    (r"(embedding|text_embedder|global_embedder)$", (("fsdp", "tp"), None)),
    (r"head$", (None, ("fsdp", "tp"))),
    (r"heads/.*$", (None, ("fsdp", "tp"))),
    (r"embeddings/.*$", (("fsdp", "tp"), None)),
    # everything else (vectors, norms, tags) replicated
    (r".*", ()),
)


def spec_for_path(path: str) -> tuple:
    for pat, spec in _RULES:
        if re.search(pat, path):
            return spec
    return ()


def _fit_spec(spec: tuple, shape, axis_sizes: Dict[str, int]) -> tuple:
    """Drop the sharding of a dimension the mesh does not divide (the odd
    8193 Spark vocabulary): that leaf stays replicated on it."""
    fitted = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            fitted.append(entry)
            continue
        size = 1
        for a in entry if isinstance(entry, tuple) else (entry,):
            size *= axis_sizes.get(a, 1)
        fitted.append(entry if shape[i] % size == 0 else None)
    return tuple(fitted)


def param_specs(params, axis_sizes: Optional[Dict[str, int]] = None):
    """A tree like `params` (dicts and lists) of specs."""

    def one(prefix, node):
        if isinstance(node, dict):
            return {k: one(f"{prefix}{k}/", v) for k, v in node.items()}
        if isinstance(node, list):
            return [one(f"{prefix}{i}/", v) for i, v in enumerate(node)]
        spec = spec_for_path(prefix[:-1])
        if axis_sizes is not None and hasattr(node, "shape"):
            spec = _fit_spec(spec, node.shape, axis_sizes)
        return spec

    return one("", params)


def fsdp_dim(spec: tuple) -> Optional[int]:
    """The dimension a spec shards over fsdp, or None."""
    for i, entry in enumerate(spec):
        if entry == "fsdp" or (isinstance(entry, tuple) and "fsdp" in entry):
            return i
    return None


class AllGather(torch.autograd.Function):
    """(...) -> (n, ...): every rank's `x` over `group`, stacked; the
    backward sums each slot's gradient over the ranks into its owner
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_gather(x.contiguous(), axis)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.reduce_scatter(grad.contiguous(), ctx.axis), None, None


class Mesh:
    """The ranks' (dp, fsdp, tp[, sp]) mesh: its sizes (``shape``), this
    rank's coordinates (``coords``), the process group of every axis and of
    the "replica" ranks (those that share this rank's fsdp coordinate),
    and this rank's compute device."""

    local = False  # see Local

    def __init__(self, device_mesh, shape: Dict[str, int], device: torch.device):
        self.device_mesh = device_mesh
        self.shape = shape
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.axis_names = tuple(a for a in AXES if a != "sp" or shape["sp"] > 1)
        ranks = device_mesh.mesh.reshape(shape["dp"], shape["fsdp"], shape["tp"], shape["sp"])
        where = (ranks == self.rank).nonzero()[0].tolist()
        self.coords = dict(zip(AXES, where))
        self.groups = {a: device_mesh.get_group(a) for a in self.axis_names}
        # the ranks of one fsdp coordinate: a sharded leaf's gradient is
        # summed over them after its reduce-scatter over fsdp
        for f in range(shape["fsdp"]):
            group = dist.new_group(ranks[:, f].flatten().tolist())
            if f == self.coords["fsdp"]:
                self.groups["replica"] = group
        self.groups["world"] = None  # the default group

    # -- sizes ------------------------------------------------------------

    def size(self, axis: str) -> int:
        if axis == "world":
            return self.world
        if axis == "replica":
            return self.world // self.shape["fsdp"]
        return self.shape[axis]

    @property
    def rows(self) -> int:
        """The parts the batch rows split into (dp x fsdp)."""
        return self.shape["dp"] * self.shape["fsdp"]

    @property
    def row_part(self) -> int:
        return self.coords["dp"] * self.shape["fsdp"] + self.coords["fsdp"]

    # -- collectives (out of place; every call is issued, groups of one included)

    def _run(self, op) -> None:
        if not timing["on"]:
            op()
            return
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        op()
        if cuda:
            torch.cuda.synchronize(self.device)
        timing["s"] += time.perf_counter() - t
        timing["calls"] += 1

    def all_reduce(self, x: torch.Tensor, axis: str = "world") -> torch.Tensor:
        y = x.detach().clone()
        self._run(lambda: dist.all_reduce(y, group=self.groups[axis]))
        return y

    def all_gather(self, x: torch.Tensor, axis: str, dim: Optional[int] = None) -> torch.Tensor:
        """Every rank's `x` over `axis`: stacked on a new leading dimension
        (dim None), or concatenated along `dim`."""
        n = self.size(axis)
        x = x.detach().contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        self._run(lambda: dist.all_gather_into_tensor(out, x, group=self.groups[axis]))
        parts = out.reshape((n,) + tuple(x.shape))
        return parts if dim is None else torch.cat(parts.unbind(0), dim)

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: Optional[int] = None) -> torch.Tensor:
        """The sum over `axis`'s ranks of `x`, of which this rank keeps its
        part: slot ``coords[axis]`` of the leading dimension (dim None), or
        its chunk along `dim`."""
        n = self.size(axis)
        if dim is not None:
            x = torch.stack(x.chunk(n, dim))
        shape = tuple(x.shape[1:])
        lead = shape[0] if shape else 1
        # the input as the ranks' parts concatenated (gloo takes no stack)
        x = x.detach().contiguous().reshape((n * lead,) + shape[1:])
        out = torch.empty((lead,) + shape[1:], dtype=x.dtype, device=x.device)
        self._run(lambda: dist.reduce_scatter_tensor(out, x, group=self.groups[axis]))
        return out.reshape(shape)

    def barrier(self) -> None:
        # an all-reduce on the rank's own device: NCCL's barrier picks a
        # device from the rank number
        self.all_reduce(torch.zeros(1, device=self.device))

    # -- sharding ---------------------------------------------------------

    def layout(self, params, trainable) -> Dict[str, Optional[int]]:
        """{path: the dimension its fsdp shard is taken along, or None} of
        every leaf; frozen leaves (not in `trainable`) stay replicated. At
        fsdp = 1 a shard is the whole leaf, and its gather and
        reduce-scatter are still issued."""
        sizes = {a: self.size(a) for a in ("dp", "fsdp", "tp")}
        specs = flatten(param_specs(params, sizes))
        return {p: fsdp_dim(specs[p]) if p in trainable else None for p in flatten(params)}

    def shard(self, x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's fsdp shard of a full leaf (a copy), or the leaf."""
        if dim is None:
            return x
        return x.chunk(self.shape["fsdp"], dim)[self.coords["fsdp"]].contiguous().clone()

    def local_batch(self, batch: Dict[str, Any], rows: bool = True) -> Dict[str, Any]:
        """This rank's part of a global batch: rows part ``row_part`` of
        ``rows`` (unless the rows are this rank's already), and under sp,
        of every leaf with a time axis (ndim >= 2), part ``coords["sp"]``
        of T. '_'-prefixed metadata passes through."""
        out = {}
        for k, v in batch.items():
            if k.startswith("_") or getattr(v, "ndim", 0) == 0:
                out[k] = v
                continue
            if rows:
                B = v.shape[0]
                if B % self.rows:
                    raise ValueError(f"batch of {B} rows: not divisible by dp x fsdp = "
                                     f"{self.rows}")
                b = B // self.rows
                v = v[self.row_part * b:(self.row_part + 1) * b]
            sp = self.shape["sp"]
            if sp > 1 and v.ndim >= 2:
                T = v.shape[1]
                if T % sp:
                    raise ValueError(f"{k}: T = {T} is not divisible by sp = {sp}")
                t = T // sp
                v = v[:, self.coords["sp"] * t:(self.coords["sp"] + 1) * t]
            out[k] = v
        return out


class Local(Mesh):
    """The mesh of one process without a process group: every axis is 1,
    every collective the identity. The train step, the trainer and the
    checkpoints run on it when there is no process group; inside its step
    ``current()`` stays None, so the losses take their single-device
    form."""

    local = True

    def __init__(self, device=None):
        self.device_mesh, self.groups = None, {}
        self.shape = {a: 1 for a in AXES}
        self.coords = {a: 0 for a in AXES}
        self.device = torch.device(device) if device is not None else None
        self.rank, self.world = 0, 1
        self.axis_names = AXES[:3]

    def all_reduce(self, x: torch.Tensor, axis: str = "world") -> torch.Tensor:
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: Optional[int] = None) -> torch.Tensor:
        return x[None] if dim is None else x

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: Optional[int] = None) -> torch.Tensor:
        return x[0] if dim is None else x

    def barrier(self) -> None:
        pass

    def local_batch(self, batch: Dict[str, Any], rows: bool = True) -> Dict[str, Any]:
        return batch


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, sp: int = 1,
              device_type: str = "cuda", device: Optional[torch.device] = None) -> Mesh:
    """The mesh over every rank of the initialised process group
    (``torch.distributed.device_mesh.init_device_mesh``). `device` is this
    rank's compute device (default: the current CUDA device, or the CPU)."""
    if tp > 1:
        raise NotImplementedError("tensor parallelism is not ported yet: use --mesh tp=1")
    for name, n in (("dp", dp), ("fsdp", fsdp), ("sp", sp)):
        if n < 1:
            raise ValueError(f"mesh axis {name} = {n}: must be >= 1")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised")
    n, world = dp * fsdp * tp * sp, dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh dp={dp} x fsdp={fsdp} x tp={tp} x sp={sp} = {n} ranks; the "
                         f"world has {world}: the mesh must hold every rank")
    from torch.distributed.device_mesh import init_device_mesh

    shape = {"dp": dp, "fsdp": fsdp, "tp": tp, "sp": sp}
    names = AXES if sp > 1 else AXES[:3]
    dm = init_device_mesh(device_type, tuple(shape[a] for a in names), mesh_dim_names=names)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
                  else torch.device("cpu"))
    return Mesh(dm, shape, device)


def shard_params(mesh: Mesh, tree, layout: Dict[str, Optional[int]]):
    """The rank's fsdp shards of a tree's leaves (or of a flat {path:
    leaf} dict's), each cut along its ``layout`` dimension; a leaf the
    layout leaves out or at None stays whole."""
    return unflatten({p: mesh.shard(t, layout.get(p)) for p, t in flatten(tree).items()},
                     like=tree)


def gather_params(mesh: Mesh, tree, layout: Dict[str, Optional[int]]):
    """The whole leaves from the ranks' shards (every rank gets them)."""
    gather = lambda t, d: t if d is None else mesh.all_gather(t, "fsdp", dim=d)
    return unflatten({p: gather(t, layout.get(p)) for p, t in flatten(tree).items()},
                     like=tree)


# -- the step's mesh ------------------------------------------------------

# a module global, not a context variable: the backward's replay of a
# checkpointed block reads it on autograd's device thread
_CURRENT: Optional[Mesh] = None


def current() -> Optional[Mesh]:
    """The mesh of the train step whose loss is running, or None."""
    return _CURRENT


@contextlib.contextmanager
def active(mesh: Optional[Mesh]) -> Iterator[None]:
    """`mesh` is the step's mesh while the block runs (a ``Local`` one
    leaves it None)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, None if mesh is None or mesh.local else mesh
    try:
        yield
    finally:
        _CURRENT = prev


def sp_size() -> int:
    m = _CURRENT
    return 1 if m is None else m.shape["sp"]


def sp_prev_row(last: torch.Tensor, first: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The token shift's halo under sp: the previous rank's `last` row
    (B, C), differentiable; the first rank takes `first` (the carried
    state, or None for zeros). Without sp, `first`."""
    m = _CURRENT
    if m is None or m.shape["sp"] == 1:
        return first
    rows = AllGather.apply(last, m, "sp")
    s = m.coords["sp"]
    keep = torch.zeros_like(last) if first is None else first.to(last.dtype)
    # one graph on every rank: the first rank's select reaches the gather
    # too (with zeros), so every rank runs its backward collective
    first_rank = torch.full((), s == 0, dtype=torch.bool, device=last.device)
    return torch.where(first_rank, keep, rows[s - 1])


def sp_next_first(x: torch.Tensor, fill) -> torch.Tensor:
    """Under sp, the next rank's first column of `x` (B, T) (no gradient);
    the last rank gets `fill`."""
    m = _CURRENT
    cols = m.all_gather(x[:, :1], "sp")
    s = m.coords["sp"]
    return cols[s + 1] if s + 1 < m.shape["sp"] else torch.full_like(x[:, :1], fill)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A loss denominator's count summed over every rank of the step's
    mesh (no gradient), or `x` outside a step."""
    m = _CURRENT
    return x if m is None else m.all_reduce(x)


def global_rows(b: int) -> int:
    """The global batch of a rank holding `b` rows."""
    m = _CURRENT
    return b if m is None else b * m.rows


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's part of the mean over the global batch of a tensor
    whose leading dimension is the batch: x.mean() outside a step."""
    m = _CURRENT
    return x.mean() if m is None else x.sum() / (x.numel() * m.rows)
