"""Capture-safety analyzer for the CUDA graphs (rules GT001-GT004).

On the card every wave replays the scheduling cycle captured as one CUDA
graph (sched/graphs.py). A capture records the card's work only: whatever
the captured Python does on the host runs once, at capture, and a call
that waits for the card inside a capture fails it. These rules keep the
captured code, and the code that feeds it, free of such calls. They keep
the rule IDs of the JAX package's trace-safety rules, with torch meanings:

GT001  device work at import: a tensor built on a CUDA device, ``.cuda()``,
       a ``torch.cuda`` call that creates a context (``current_device``,
       ``set_device``, ``Stream()``, ``Event()``,
       ``get_device_properties``...), or any call into the kernel build
       module (``[tracesafe] build_modules``), in a module body, a class
       body or a default argument. Kernels build on first use, never at
       import, and importing the package must not touch the card.

GT002  a host sync or Python side effect in captured code: within every
       function reachable, through the resolved call graph, from the
       declared capture roots (``[tracesafe] capture_roots``: the cycle
       is handed to the graph as a callable, which static reachability
       cannot follow) — ``.item()``, ``.tolist()``, ``.cpu()``,
       ``.numpy()``, ``float()/int()/bool()`` on a non-shape value,
       ``torch.cuda.synchronize`` and ``.synchronize()``, the ops whose
       output shape depends on the data (``nonzero``, ``unique``,
       ``masked_select``, one-argument ``torch.where``), ``print()``,
       clock reads and ``numpy.asarray/array``. A function listed under
       ``[tracesafe.capture_stops]`` (with the reason it never runs inside
       a capture) ends the walk. A root that resolves to no function is
       a violation, as a stale rank is (GL004).

GT003  an explicit synchronize in production code: ``torch.cuda.
       synchronize()`` or ``.synchronize()`` on an Event or a Stream,
       allowed only in the functions listed, each with its reason, under
       ``[tracesafe.allow_functions]`` (``"file.py:Class.method" =
       "reason"``). An entry that names no such call is stale.

GT004  a host sync in the mesh layer (``[tracesafe] parallel_modules``):
       ``synchronize``, ``.item()``, ``.tolist()``, ``.cpu()`` or
       ``.numpy()`` anywhere in it. The sharded cycle is device work end
       to end; a sync there stalls every shard at pick cadence, so it
       belongs on the host facade (Scheduler, PendingWave).
"""

from __future__ import annotations

import ast
from typing import Optional

from gie_tpu_torch.lint.blocking import body_nodes
from gie_tpu_torch.lint.model import (
    FunctionInfo, RepoIndex, Violation, dotted_name)

# torch.cuda calls that create (or need) a CUDA context.
_CONTEXT_CALLS = {
    "torch.cuda.init", "torch.cuda.current_device", "torch.cuda.set_device",
    "torch.cuda.Stream", "torch.cuda.Event", "torch.cuda.get_device_properties",
    "torch.cuda.current_stream", "torch.cuda.default_stream",
    "torch.cuda.synchronize", "torch.cuda.mem_get_info",
}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_DATA_SHAPE_CALLS = {"torch.nonzero", "torch.unique", "torch.masked_select",
                     "torch.argwhere", "torch.unique_consecutive"}
_DATA_SHAPE_METHODS = {"nonzero", "unique", "masked_select", "argwhere",
                       "unique_consecutive"}
_NUMPY_PULLS = {"numpy.asarray", "numpy.array", "numpy.copy"}
_CLOCK_CALLS = {
    "time.time", "time.monotonic", "time.perf_counter",
    "time.process_time", "time.time_ns", "time.monotonic_ns",
    "time.perf_counter_ns",
}
# Static-shape reads that make float()/int() legitimate in captured code.
_STATIC_ATTRS = {"shape", "ndim", "size", "dtype"}
_SYNC = "torch.cuda.synchronize"


def _import_time_values(tree: ast.Module):
    """(description, node) pairs evaluated at import time: module and
    class bodies (also under a module-level if/try) and defaults."""
    def from_body(body, where):
        for node in body:
            if isinstance(node, ast.Assign):
                names = ", ".join(ast.unparse(t) for t in node.targets)
                yield f"{where}{names}", node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                yield f"{where}{ast.unparse(node.target)}", node.value
            elif isinstance(node, ast.Expr):
                yield where.rstrip(".") or "<module>", node.value
            elif isinstance(node, ast.ClassDef):
                yield from from_body(node.body, f"{where}{node.name}.")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for d in list(node.args.defaults) + [
                    d for d in node.args.kw_defaults if d is not None
                ]:
                    yield f"{where}{node.name}(default)", d
            elif isinstance(node, ast.If):
                yield from from_body(node.body + node.orelse, where)
            elif isinstance(node, ast.Try):
                yield from from_body(
                    node.body + node.orelse + node.finalbody
                    + [s for h in node.handlers for s in h.body], where)

    yield from from_body(tree.body, "")


def _names_cuda(index: RepoIndex, mi, expr: ast.expr) -> bool:
    """Does `expr` name a CUDA device ("cuda", "cuda:0",
    torch.device("cuda"...))?"""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.startswith("cuda")
    if isinstance(expr, ast.Call):
        dn = dotted_name(expr.func)
        r = (index._resolve_dotted_import(mi, dn) or dn) if dn else None
        if r == "torch.device" and expr.args:
            return _names_cuda(index, mi, expr.args[0])
    return False


def _import_time_device_work(index: RepoIndex, mi, value: ast.AST,
                             build_modules: tuple) -> Optional[str]:
    for call in ast.walk(value):
        if not isinstance(call, ast.Call):
            continue
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "cuda":
            return ".cuda()"
        if (isinstance(func, ast.Attribute) and func.attr == "to"
                and any(_names_cuda(index, mi, a) for a in call.args)):
            return ".to(<cuda device>)"
        dn = dotted_name(func)
        if dn is None:
            continue
        r = index._resolve_dotted_import(mi, dn) or dn
        if r in _CONTEXT_CALLS:
            return f"{r}()"
        if any(r.startswith(m + ".") for m in build_modules):
            return f"{r}() (kernel build)"
        if r.startswith("torch.") and any(
                k.arg == "device" and _names_cuda(index, mi, k.value)
                for k in call.keywords):
            return f"{r}(device=<cuda>)"
    return None


def _find_function(index: RepoIndex, dotted: str) -> Optional[FunctionInfo]:
    """"pkg.mod.Class.method" or "pkg.mod.func" -> FunctionInfo."""
    parts = dotted.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        mi = index.modules.get(".".join(parts[:cut]))
        if mi is None:
            continue
        rest = parts[cut:]
        if len(rest) == 1:
            return mi.functions.get(rest[0])
        if len(rest) == 2 and rest[0] in mi.classes:
            return mi.classes[rest[0]].find_method(rest[1])
        return None
    return None


def _functions_by_where(index: RepoIndex) -> dict:
    return {fi.where: fi for fi in index.all_functions()}


def _mark_captured(index: RepoIndex, roots: list, stops: set) -> None:
    """Set fi.capture_chain on every function reachable from a root."""
    for fi in index.all_functions():
        fi.capture_chain = None  # type: ignore[attr-defined]
    for fi in roots:
        fi.capture_chain = "captured here"
    changed = True
    while changed:
        changed = False
        for fi in index.all_functions():
            if fi.capture_chain is None or fi.where in stops:
                continue
            for cs in fi.calls.values():
                t = cs.target
                if (t is not None and t.capture_chain is None
                        and t.where not in stops):
                    t.capture_chain = f"called from capture via {fi.where}"
                    changed = True


_HOST_ANNOTATIONS = {"int", "float", "bool", "str"}


def _host_names(fi: FunctionInfo, index: RepoIndex) -> set:
    """Names that hold host values in `fi`: parameters annotated int,
    float, bool or str (or Optional of one) or defaulting to a constant,
    the module's globals the function does not rebind, loop indices over
    range()/enumerate(), and names bound only to values _is_static_arg
    accepts (e.g. unpacked from a ``.shape``)."""
    args = fi.node.args
    params = list(args.posonlyargs) + list(args.args) + list(
        args.kwonlyargs)
    defaults = dict(zip([a.arg for a in args.posonlyargs + args.args][
        len(args.posonlyargs + args.args) - len(args.defaults):],
        args.defaults))
    defaults.update({a.arg: d for a, d in zip(args.kwonlyargs,
                                              args.kw_defaults) if d})
    host = set()
    for a in params:
        ann = a.annotation
        if ann is not None:
            text = ast.unparse(ann).strip("'\"")
            parts = {t.strip() for t in text.replace("Optional[", "")
                     .rstrip("]").split("|")}
            if parts - {"None"} and parts - {"None"} <= _HOST_ANNOTATIONS:
                host.add(a.arg)
                continue
        d = defaults.get(a.arg)
        if (ann is None and isinstance(d, ast.Constant)
                and d.value is not None):
            host.add(a.arg)

    def bind(target, static: bool, bound: dict):
        if isinstance(target, ast.Name):
            bound[target.id] = bound.get(target.id, True) and static
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                bind(e, static, bound)
        elif isinstance(target, ast.Starred):
            bind(target.value, static, bound)

    base = set(host)
    glob = _module_globals(fi.module)
    host = base | glob
    for _ in range(16):          # a fixpoint, in a few rounds in practice
        bound: dict = {}
        for node in body_nodes(fi.node):
            if isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
                fn = dotted_name(it.func) if isinstance(it, ast.Call) else None
                if fn == "range":
                    bind(node.target, True, bound)
                elif (fn == "enumerate" and isinstance(node.target, ast.Tuple)
                        and node.target.elts):
                    bind(node.target.elts[0], True, bound)
                    for e in node.target.elts[1:]:
                        bind(e, False, bound)
                else:
                    bind(node.target, False, bound)
            elif isinstance(node, ast.Assign):
                static = _is_static_arg(node.value, fi, index, host)
                for t in node.targets:
                    bind(t, static, bound)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                if node.value is not None:
                    bind(node.target, _is_static_arg(
                        node.value, fi, index, host), bound)
        new = (base | (glob - set(bound))
               | {n for n, ok in bound.items() if ok})
        if new == host:
            break
        host = new
    return host


def _module_globals(mi) -> set:
    """Names a module binds at its top level (constants, imports of
    values): host values, since GT001 keeps device tensors out of them."""
    out = set()
    for node in mi.tree.body:
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, ast.AnnAssign) else [])
        for t in targets:
            out.update(n.id for n in ast.walk(t) if isinstance(n, ast.Name))
    return out


def _is_static_arg(arg: ast.expr, fi: FunctionInfo = None,
                   index: RepoIndex = None, host: set = frozenset()) -> bool:
    """float(x) is capture-safe when x is a host value rather than a
    tensor's: a literal, a static property (shape/ndim/len), a module's
    constant (``C.Status.OK``), a numpy scalar, or a name _host_names
    found bound to one of those."""
    if isinstance(arg, ast.Constant):
        return True
    if isinstance(arg, ast.Name):
        return arg.id in host
    if isinstance(arg, ast.UnaryOp):
        return _is_static_arg(arg.operand, fi, index, host)
    if isinstance(arg, ast.BinOp):
        return (_is_static_arg(arg.left, fi, index, host)
                and _is_static_arg(arg.right, fi, index, host))
    if isinstance(arg, ast.Call):
        dn = dotted_name(arg.func)
        if dn == "len":
            return True
        if dn is not None and fi is not None:
            r = index._resolve_dotted_import(fi.module, dn) or dn
            return r.startswith("numpy.")
        return False
    if isinstance(arg, ast.Subscript):
        return _is_static_arg(arg.value, fi, index, host)
    if isinstance(arg, ast.Attribute):
        if arg.attr in _STATIC_ATTRS:
            return True
        # A constant of an imported module (an enum member, a flag).
        dn = dotted_name(arg)
        if dn is not None and fi is not None:
            head = dn.split(".")[0]
            mi = fi.module
            return head in mi.imports or head in mi.from_names
        return False
    return False


def _is_sync(cs) -> bool:
    return cs.ext == _SYNC or cs.method == "synchronize"


def _captured_violation(cs, node: ast.Call, fi: FunctionInfo,
                        index: RepoIndex, host: set) -> Optional[str]:
    ext = cs.ext
    if ext is not None:
        if ext in ("float", "int", "bool"):
            if node.args and not _is_static_arg(node.args[0], fi, index,
                                                host):
                return (f"{ext}() on a tensor's value forces a host sync "
                        f"(implicit D2H) and fails the capture")
            return None
        if ext == "print":
            return ("print() inside captured code runs at capture only, "
                    "never on a replay")
        if ext in _NUMPY_PULLS:
            return (f"{ext}() inside captured code pulls the value to the "
                    f"host (D2H sync)")
        if ext in _CLOCK_CALLS:
            return (f"{ext}() inside captured code is read once, at "
                    f"capture, never on a replay")
        if ext == _SYNC:
            return "torch.cuda.synchronize() inside captured code"
        if ext in _DATA_SHAPE_CALLS or (
                ext == "torch.where" and len(node.args) == 1
                and not node.keywords):
            return (f"{ext}() inside captured code has a data-dependent "
                    f"output shape (a host sync)")
    if cs.method is not None:
        if cs.method in _HOST_SYNC_METHODS:
            return (f".{cs.method}() inside captured code forces a host "
                    f"sync")
        if cs.method in _DATA_SHAPE_METHODS:
            return (f".{cs.method}() inside captured code has a "
                    f"data-dependent output shape (a host sync)")
    return None


def _where_table(tcfg: dict, key: str, config_file: str) -> dict:
    """A [tracesafe.<key>] table of "file.py:qualname" = "reason"."""
    table = tcfg.get(key, {})
    if not isinstance(table, dict):
        raise ValueError(f"{config_file}: [tracesafe.{key}] must be a table "
                         f"of \"file.py:qualname\" = \"reason\"")
    for where, reason in table.items():
        if not isinstance(reason, str) or not reason.strip():
            raise ValueError(f"{config_file}: [tracesafe.{key}] {where!r} "
                             f"needs a reason")
    return table


def run(index: RepoIndex, cfg: dict,
        config_file: str = "lockorder.toml") -> list[Violation]:
    out: list[Violation] = []
    tcfg = cfg.get("tracesafe", {})
    allow = _where_table(tcfg, "allow_functions", config_file)
    stops = set(_where_table(tcfg, "capture_stops", config_file))
    build_modules = tuple(tcfg.get("build_modules", []))
    by_where = _functions_by_where(index)

    # GT001 — device work at import.
    for mi in index.modules.values():
        for desc, value in _import_time_values(mi.tree):
            what = _import_time_device_work(index, mi, value, build_modules)
            if what is not None:
                out.append(Violation(
                    "GT001", mi.file, value.lineno, desc or "<module>",
                    f"{what} at import time — importing the package must "
                    f"not touch the card; build kernels and device tensors "
                    f"on first use"))

    # GT002 — host syncs / side effects in captured code.
    roots = []
    for name in tcfg.get("capture_roots", []):
        fi = _find_function(index, name)
        if fi is None:
            out.append(Violation(
                "GT002", config_file, 0, name,
                f"capture root {name!r} resolves to no function in the "
                f"analyzed tree — fix or remove the entry"))
        else:
            roots.append(fi)
    for where in sorted(stops):
        if where not in by_where:
            out.append(Violation(
                "GT002", config_file, 0, where,
                f"[tracesafe.capture_stops] names {where!r}, which is no "
                f"function of the analyzed tree — remove the entry"))
    _mark_captured(index, roots, stops)
    for fi in index.all_functions():
        chain = getattr(fi, "capture_chain", None)
        if chain is None or fi.where in stops:
            continue
        origin = "" if chain == "captured here" else f" ({chain})"
        host = _host_names(fi, index)
        for node in body_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            cs = fi.calls.get(id(node))
            msg = (None if cs is None
                   else _captured_violation(cs, node, fi, index, host))
            if msg is not None:
                out.append(Violation(
                    "GT002", fi.module.file, node.lineno, fi.qualname,
                    msg + origin))

    # GT003 — explicit synchronize in production code.
    used = set()
    for fi in index.all_functions():
        if getattr(fi, "capture_chain", None) is not None:
            continue  # covered (and attributed) by GT002
        for cs in fi.calls.values():
            if not _is_sync(cs):
                continue
            if fi.where in allow:
                used.add(fi.where)
                continue
            out.append(Violation(
                "GT003", fi.module.file, cs.node.lineno, fi.qualname,
                "synchronize() in production code stalls the host until "
                "the card drains — wait on the wave's own event where a "
                "result is due (list the function with its reason under "
                "[tracesafe.allow_functions] if intentional)"))
    for where in sorted(set(allow) - used):
        out.append(Violation(
            "GT003", config_file, 0, where,
            f"[tracesafe.allow_functions] names {where!r}, which makes no "
            f"synchronize call — remove the entry"))

    # GT004 — host syncs in the mesh layer.
    gt4_modules = tuple(tcfg.get("parallel_modules", []))
    for fi in index.all_functions():
        mod = fi.module.modname
        if not any(mod == m or mod.startswith(m + ".")
                   for m in gt4_modules):
            continue
        for cs in fi.calls.values():
            msg = None
            if _is_sync(cs):
                msg = "synchronize() in the sharded-cycle layer"
            elif cs.method in ("item", "tolist", "cpu", "numpy"):
                msg = f".{cs.method}() in the sharded-cycle layer"
            if msg is not None:
                out.append(Violation(
                    "GT004", fi.module.file, cs.node.lineno, fi.qualname,
                    msg + " — a D2H sync here stalls every shard of the "
                    "mesh at pick cadence; materialize on the host facade "
                    "(Scheduler/PendingWave) instead"))
    return out
