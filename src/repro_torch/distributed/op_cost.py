"""Per-device cost census of one eager step (``repro.distributed.hlo_cost``).

The reference parses the compiled, SPMD-partitioned HLO and scales each
while body by its trip count. The port has no compiled program: it runs
the step once under ``Census``, a ``TorchDispatchMode`` that counts every
op where it runs on local shards, below DTensor's dispatch, so the numbers
are per device. (A mode that counts the DTensor-level ops, as
``FlopCounterMode`` does, sees the global shapes: a sharded matmul would
count the whole mesh's flops.) Eager Python loops (layers, microbatches,
attention chunks) run once per iteration and are counted so, which takes
the place of the reference's trip counts. It accumulates:

  * flops            — matmul / conv / attention ops, from
                       ``torch.utils.flop_counter``'s formulas;
  * traffic bytes    — input + output bytes of every op that is not a
                       view (each eager op is one kernel, so its boundary
                       is its memory traffic);
  * collective bytes — output bytes of every functional collective
                       (all-gather, all-reduce, reduce-scatter,
                       all-to-all), by kind and by mesh axis;
  * peak live bytes  — the largest sum of live op outputs at any point of
                       the step (what the reference's ``temp_size``
                       reports, here from the order eager ops run in).

Where DTensor has no sharding rule for an op (``Census.fallbacks`` names
them) the census redistributes its DTensor inputs to ``Replicate`` and runs
the op on the whole tensors, so the gathers it costs are in the counts.
The collective counts are ``CommDebugMode``'s (this mode is one).
"""
from __future__ import annotations

import copy
import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import _MaskPartial
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import _pop_mode, _push_mode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

# the reference's collective names, by functional-collective op name
COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

_VIEW_OPS = {
    "view", "_unsafe_view", "reshape", "alias", "as_strided", "t",
    "transpose", "permute", "expand", "detach", "slice", "select",
    "unsqueeze", "squeeze", "split", "split_with_sizes", "unbind", "chunk",
    "narrow", "movedim", "view_as", "unfold", "diagonal", "_reshape_alias",
    "lift_fresh", "wait_tensor",
}
aten = torch.ops.aten
_MATMULS = (aten.mm, aten.bmm, aten.addmm, aten.baddbmm)

# ops that allocate and move no bytes
_ALLOC_OPS = {"empty", "empty_strided", "new_empty", "empty_like",
              "new_empty_strided"}

def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
        return t.numel() * t.element_size()
    return 0


@dataclasses.dataclass
class OpCost:
    """The reference's ``HloCost``: per-device totals of one step."""

    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_ops: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    collective_bytes_by_axis: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    peak_live_bytes: int = 0
    n_ops: int = 0
    fallbacks: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the first failure of each op that fell back: placements, shapes and
    # DTensor's message
    fallback_reasons: Dict[str, str] = dataclasses.field(
        default_factory=dict)


class Census(CommDebugMode):
    """Count one step's per-device cost (see the module docstring).
    ``group_axes`` maps a process group's name to its mesh axis name, so
    collective bytes can be split by axis (``mesh_group_axes``)."""

    def __init__(self, group_axes: Dict[str, str] = None):
        super().__init__()
        self.cost = OpCost()
        self.group_axes = dict(group_axes or {})
        self._passthrough = False
        self._internal = 0
        # the mesh dims each failing (op, placements, shapes) replicates
        self._plans: Dict[Any, tuple] = {}
        self._submeshes: Dict[Any, Any] = {}
        self._memo: Dict[Any, Any] = {}
        self._live = 0

    # -------------------------------------------------------- bookkeeping
    def _track(self, out) -> None:
        for t in tree_flatten(out)[0]:
            n = _nbytes(t)
            if not n:
                continue
            self._live += n
            self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                            self._live)
            weakref.finalize(t, self._release, n)

    def _release(self, n: int) -> None:
        self._live -= n

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        c.n_ops += 1
        name = func._overloadpacket.__name__
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += float(flop_registry[packet](*args, **kwargs,
                                                   out_val=out))
        kind = COLLECTIVE_KIND.get(name)
        if kind is not None:
            b = float(sum(_nbytes(t) for t in tree_flatten(out)[0]))
            d = c.collective_ops.setdefault(kind, {"count": 0, "bytes": 0.0})
            d["count"] += 1
            d["bytes"] += b
            c.collective_bytes += b
            group = next((a for a in tree_flatten((args, kwargs))[0]
                          if isinstance(a, str)), None)
            axis = self.group_axes.get(group, "unknown")
            c.collective_bytes_by_axis[axis] = \
                c.collective_bytes_by_axis.get(axis, 0.0) + b
            return
        if name in _VIEW_OPS:
            return
        self._track(out)
        if name in _ALLOC_OPS:
            return
        c.traffic_bytes += float(
            sum(_nbytes(t) for t in tree_flatten((args, kwargs))[0])
            + sum(_nbytes(t) for t in tree_flatten(out)[0]))

    # ----------------------------------------------------------- dispatch
    def _redistribute(self, t, placements):
        """``t.redistribute`` counted below, with DTensor's own handling of
        every DTensor op it issues (some torch versions dispatch ops on
        ``t`` inside it, which the census must not take apart again)."""
        self._internal += 1
        try:
            return self._reenter(
                lambda x: x.redistribute(x.device_mesh, placements), (t,),
                {})
        finally:
            self._internal -= 1

    def _reenter(self, func, args, kwargs):
        _push_mode(self)
        try:
            return func(*args, **kwargs)
        finally:
            _pop_mode()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation infers output shapes on
            # global-shape fake tensors: not work any device does
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            if self._passthrough or self._internal:
                # the re-entered call (or one inside a census-issued
                # redistribute): let DTensor run with this mode on the
                # stack, so its local ops and collectives land below
                self._passthrough = False
                return NotImplemented
            flat = tree_flatten((args, kwargs))[0]
            mkey = _memo_key(func, flat)
            hit = self._memo.get(mkey) if mkey is not None else None
            if hit is not None:
                return self._replay(hit, flat)
            before = self._snapshot()
            out = self._dispatch_dtensor(func, args, kwargs)
            template = _template(out, flat) if mkey is not None else None
            if template is not None:
                self._memo[mkey] = (template, self._delta(before))
            return out
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self._count(func, args, kwargs, out)
        return out

    # ------------------------------------------------------------- memo
    # Every layer and microbatch repeats the same DTensor ops on the same
    # shapes and placements; the first run of each (op, inputs' specs,
    # other arguments) records its outputs' specs and the counts it added,
    # and later runs replay both without dispatching.
    def _snapshot(self):
        c = self.cost
        return (c.flops, c.traffic_bytes, c.collective_bytes, c.n_ops,
                {k: dict(v) for k, v in c.collective_ops.items()},
                dict(c.collective_bytes_by_axis), dict(c.fallbacks),
                dict(self.comm_counts))

    def _delta(self, before):
        now = self._snapshot()
        out = [now[i] - before[i] for i in range(4)]
        for i in range(4, 8):
            d = {}
            for k, v in now[i].items():
                if isinstance(v, dict):
                    old = before[i].get(k, {})
                    dv = {kk: vv - old.get(kk, 0) for kk, vv in v.items()}
                    if any(dv.values()):
                        d[k] = dv
                elif v - before[i].get(k, 0):
                    d[k] = v - before[i].get(k, 0)
            out.append(d)
        return out

    def _replay(self, hit, flat):
        template, delta = hit
        c = self.cost
        c.flops += delta[0]
        c.traffic_bytes += delta[1]
        c.collective_bytes += delta[2]
        c.n_ops += delta[3]
        for k, dv in delta[4].items():
            d = c.collective_ops.setdefault(k, {"count": 0, "bytes": 0.0})
            for kk, vv in dv.items():
                d[kk] = d.get(kk, 0) + vv
        for target, d in ((c.collective_bytes_by_axis, delta[5]),
                          (c.fallbacks, delta[6]),
                          (self.comm_counts, delta[7])):
            for k, v in d.items():
                target[k] = target.get(k, 0) + v
        return self._build(template, flat)

    def _build(self, t, flat):
        kind = t[0]
        if kind == "in":
            return flat[t[1]]
        if kind == "val":
            return t[1]
        if kind == "seq":
            return t[1](self._build(x, flat) for x in t[2])
        _, lshape, lstride, dtype, spec = t
        local = torch.empty_strided(lshape, lstride, dtype=dtype,
                                    device="meta")
        self._track(local)
        # the recorded output's spec (mesh, placements, global shape and
        # stride), without from_local's autograd function
        return DTensor(local, spec, requires_grad=False)

    def _dispatch_dtensor(self, func, args, kwargs):
        if func._overloadpacket in _MATMULS:
            args = self._steer_matmul(func, args)
        if func in _REDUCTIONS and _sharded_on(args[0], args[1]):
            return self._reenter(_REDUCTIONS[func], args, kwargs)
        key = (func, tuple(
            (tuple(a.placements), tuple(a.shape))
            for a in tree_flatten((args, kwargs))[0]
            if isinstance(a, DTensor)))
        plan = self._plans.get(key)
        if plan is not None:
            return self._run_replicating(func, args, kwargs, plan)
        return self._first_run(func, args, kwargs, key)

    def _steer_matmul(self, func, args):
        """Resolve a product's conflicts on a mesh dim as GSPMD does for
        FSDP, before DTensor picks: where one operand's contraction dim
        is sharded and the other's free dim is sharded over the same mesh
        dim, gather the first (the FSDP weight all-gather); where both
        free dims are, gather the smaller operand. DTensor's choice prices
        only its inputs' moves, and would instead reshard the activation
        onto the contraction dim and leave a partial of the whole output
        to all-reduce."""
        off = 1 if func._overloadpacket in (aten.addmm, aten.baddbmm) else 0
        a, b = args[off], args[off + 1]
        if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
            return args
        ca, cb = a.dim() - 1, b.dim() - 2   # contraction dims
        pa, pb = list(a.placements), list(b.placements)
        for i in range(a.device_mesh.ndim):
            sa = pa[i].dim if isinstance(pa[i], Shard) else None
            sb = pb[i].dim if isinstance(pb[i], Shard) else None
            if sa is None or sb is None or (sa == ca and sb == cb):
                continue
            if sa == ca:
                pa[i] = Replicate()
            elif sb == cb:
                pb[i] = Replicate()
            elif a.numel() <= b.numel():
                pa[i] = Replicate()
            else:
                pb[i] = Replicate()

        def move(t, pl):
            if tuple(pl) == tuple(t.placements):
                return t
            return self._redistribute(t, pl)

        snap = (copy.deepcopy(self.cost), dict(self.comm_counts))
        try:
            moved = move(a, pa), move(b, pb)
        except RecursionError:
            raise
        except Exception:  # noqa: BLE001
            # DTensor cannot gather this layout (an uneven flattened shard
            # of its own making): leave the product to its rule
            self.cost, counts = snap
            self.comm_counts.clear()
            self.comm_counts.update(counts)
            return args
        args = list(args)
        args[off], args[off + 1] = moved
        return tuple(args)

    def _dtensor_call(self, func, args, kwargs):
        """DTensor's rule for ``func``, on the mesh dims over which some
        input is not replicated: over a dim where every input is
        replicated the op stays replicated (DTensor would otherwise
        shard it there for free and leave a partial to all-reduce, which
        the reference's rules never ask for). With every input replicated
        everywhere the op runs on the local tensors."""
        dts = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, DTensor)]
        mesh = dts[0].device_mesh
        keep = tuple(i for i in range(mesh.ndim)
                     if any(not isinstance(a.placements[i], Replicate)
                            for a in dts))
        if len(keep) < mesh.ndim and all(a.device_mesh == mesh
                                         for a in dts):
            sub = self._submesh(mesh, keep) if keep else None

            def down(a):
                if not isinstance(a, DTensor):
                    return a
                if sub is None:
                    return a._local_tensor
                return DTensor.from_local(
                    a._local_tensor, sub, [a.placements[i] for i in keep],
                    run_check=False, shape=a.shape, stride=a.stride())

            def up(t):
                if isinstance(t, DTensor):
                    pl = [Replicate()] * mesh.ndim
                    for j, i in enumerate(keep):
                        pl[i] = t.placements[j]
                    return DTensor.from_local(
                        t._local_tensor, mesh, pl, run_check=False,
                        shape=t.shape, stride=t.stride())
                if isinstance(t, torch.Tensor) and sub is None:
                    return DTensor.from_local(
                        t, mesh, [Replicate()] * mesh.ndim, run_check=False)
                return t

            nargs, nkwargs = tree_map(down, (args, kwargs))
            if sub is None:
                out = self._reenter(func, nargs, nkwargs)
            else:
                out = self._passthrough_call(func, nargs, nkwargs)
            written = _written_inputs(func, args, kwargs)
            for a, n in zip(written, _written_inputs(func, nargs, nkwargs)):
                if isinstance(a, DTensor):
                    # the op wrote into the sub-mesh view of a's local
                    # tensor, which is a's own storage
                    del n
            if written and _returns_inputs(func):
                return written[0] if len(written) == 1 else tuple(written)
            return tree_map(up, out)
        return self._passthrough_call(func, args, kwargs)

    def _submesh(self, mesh, keep):
        """The sub-mesh over the dims ``keep``, made once: DTensor's
        sharding cache is keyed on the mesh object."""
        key = (id(mesh), keep)
        if key not in self._submeshes:
            self._submeshes[key] = mesh[tuple(mesh.mesh_dim_names[i]
                                              for i in keep)]
        return self._submeshes[key]

    def _passthrough_call(self, func, args, kwargs):
        self._passthrough = True
        try:
            return self._settle(self._reenter(func, args, kwargs))
        finally:
            self._passthrough = False

    def _first_run(self, func, args, kwargs, key):
        """The first call with these placements: DTensor's own rule, else
        the fewest mesh dims replicated that make it run (the innermost
        axis first, then each other, then all). A failed attempt's counts
        are rolled back; the plan is kept for the next such call."""
        mesh = next(a.device_mesh for a in tree_flatten((args, kwargs))[0]
                    if isinstance(a, DTensor))
        every = tuple(range(mesh.ndim))
        plans = [()] + [(d,) for d in reversed(every)]
        if len(every) > 1:
            plans.append(every)
        first_error = None
        for plan in plans:
            snap = (copy.deepcopy(self.cost), dict(self.comm_counts))
            try:
                out = self._run_replicating(func, args, kwargs, plan)
            except RecursionError:
                raise
            except Exception as e:  # noqa: BLE001
                # no rule, or a rule that fails on these placements; a
                # genuine fault of the op fails again on whole tensors
                self.cost, counts = snap
                self.comm_counts.clear()
                self.comm_counts.update(counts)
                first_error = first_error or e
                if plan == every:
                    raise
                continue
            self._plans[key] = plan
            if plan:
                self.cost.fallback_reasons.setdefault(
                    str(func), f"{key[1]}: {str(first_error)[:300]}")
            return out
        raise AssertionError("unreachable")

    def _settle(self, out):
        """Reduce a masked partial (DTensor's vocab-parallel gather and
        embedding) at once: its mask does not follow later views."""
        def settle(t):
            if not isinstance(t, DTensor) or not any(
                    isinstance(p, _MaskPartial) for p in t.placements):
                return t
            target = [Replicate() if isinstance(p, _MaskPartial)
                      else p for p in t.placements]
            return self._redistribute(t, target)

        return tree_map(settle, out)

    def _run_replicating(self, func, args, kwargs, plan):
        """Run ``func`` with every DTensor input replicated over the mesh
        dims in ``plan`` (the gathers are counted). Over a proper subset
        DTensor runs the op; over all of them the op runs on the whole
        local tensors and its outputs are replicated DTensors. An input
        the op writes gets the result back in its own placements."""
        if not plan:
            return self._dtensor_call(func, args, kwargs)
        name = str(func)
        self.cost.fallbacks[name] = self.cost.fallbacks.get(name, 0) + 1
        mesh = next(a.device_mesh for a in tree_flatten((args, kwargs))[0]
                    if isinstance(a, DTensor))
        whole = len(plan) == mesh.ndim
        moved: Dict[int, Any] = {}

        def redistribute(a):
            if not isinstance(a, DTensor):
                return a
            target = [Replicate() if i in plan else p
                      for i, p in enumerate(a.placements)]
            r = self._redistribute(a, target)
            moved[id(a)] = r
            return r.to_local() if whole else r

        nargs, nkwargs = tree_map(redistribute, (args, kwargs))
        if whole:
            out = self._reenter(func, nargs, nkwargs)
        else:
            out = self._dtensor_call(func, nargs, nkwargs)
        written = [i for i, arg in enumerate(func._schema.arguments)
                   if arg.alias_info is not None and arg.alias_info.is_write]
        flat_in = list(args) + [kwargs.get(func._schema.arguments[i].name)
                                for i in range(len(args),
                                               len(func._schema.arguments))]
        for i in written:
            a = flat_in[i] if i < len(flat_in) else None
            if isinstance(a, DTensor):
                r = moved[id(a)]
                back = self._redistribute(r, a.placements).to_local()
                self._reenter(torch.Tensor.copy_, (a._local_tensor, back),
                              {})
        if written and func._schema.returns and all(
                r.alias_info is not None for r in func._schema.returns):
            ins = [flat_in[i] for i in written]
            return ins[0] if len(ins) == 1 else tuple(ins)
        if not whole:
            return out

        def wrap(t):
            if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
                return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                          run_check=False)
            return t

        return tree_map(wrap, out)


def _memo_key(func, flat):
    """(op, every argument's spec or value), or None where an argument
    cannot be keyed."""
    parts = [func]
    for a in flat:
        if isinstance(a, DTensor):
            parts.append(("D", tuple(a.placements), a.shape, a.stride(),
                          a.dtype, id(a.device_mesh), a.requires_grad))
        elif isinstance(a, torch.Tensor):
            parts.append(("T", a.shape, a.stride(), a.dtype, a.device.type))
        else:
            try:
                hash(a)
            except TypeError:
                return None
            parts.append((type(a), a))
    return tuple(parts)


def _template(out, flat):
    """How to rebuild ``out``: an input it returns, a DTensor's specs, or
    a value."""
    for i, a in enumerate(flat):
        if out is a:
            return ("in", i)
    if isinstance(out, DTensor):
        loc = out._local_tensor
        return ("dt", loc.shape, loc.stride(), loc.dtype, out._spec)
    if isinstance(out, (tuple, list)):
        parts = [_template(o, flat) for o in out]
        return None if None in parts else ("seq", type(out), parts)
    if isinstance(out, torch.Tensor):
        return None  # a plain tensor out of a DTensor op: not replayed
    return ("val", out)


def _sharded_on(x, dims) -> bool:
    dims = [dims] if isinstance(dims, int) else list(dims)
    dims = [d % x.dim() for d in dims]
    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and p.dim in dims for p in x.placements)


def _logsumexp(x, dim, keepdim=False):
    m = torch.amax(x, dim, keepdim=True)
    out = torch.log(torch.sum(torch.exp(x - m), dim, keepdim=True)) + m
    return out if keepdim else out.squeeze(dim)


def _softmax(x, dim, half_to_float):
    x = x.float() if half_to_float else x
    e = torch.exp(x - torch.amax(x, dim, keepdim=True))
    return e / torch.sum(e, dim, keepdim=True)


# reductions over a dim DTensor would gather whole, taken apart into
# max and sum reductions, which it reduces as partials of the reduced
# shape (the census's own rule; the values are never read)
_REDUCTIONS = {aten.logsumexp.default: _logsumexp,
               aten._softmax.default: _softmax}


def _written_inputs(func, args, kwargs):
    """The arguments ``func``'s schema says it writes, in order."""
    schema = func._schema.arguments
    flat = list(args) + [kwargs.get(schema[i].name)
                         for i in range(len(args), len(schema))]
    return [flat[i] for i, arg in enumerate(schema)
            if arg.alias_info is not None and arg.alias_info.is_write
            and i < len(flat)]


def _returns_inputs(func) -> bool:
    return bool(func._schema.returns) and all(
        r.alias_info is not None for r in func._schema.returns)


def mesh_group_axes(mesh) -> Dict[str, str]:
    """{process-group name: mesh axis name} of a ``DeviceMesh``."""
    return {mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}


def collective_counts(census: Census) -> Dict[str, int]:
    """``CommDebugMode``'s counts by the reference's collective names."""
    out: Dict[str, int] = defaultdict(int)
    for packet, n in census.get_comm_counts().items():
        kind = COLLECTIVE_KIND.get(packet.__name__)
        if kind is not None:
            out[kind] += n
    return dict(out)
