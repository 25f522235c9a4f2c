"""Shared AST index for the gie-lint analyzers.

One pass over the analyzed tree builds a cross-module index — classes,
their attribute types, lock definitions, functions, and resolved call
sites — that all three analyzers (locks, tracesafe, asynclint) consume.
The resolver is deliberately heuristic: it follows the idioms this
codebase actually uses (``self.x = ClassName(...)`` construction,
annotated parameters, simple local aliases, package-internal imports)
and reports only what it can resolve. Unresolvable receivers degrade to
method-name matching, never to guessing.

Naming: a lock is addressed as ``<module>.<Class>.<attr>`` (or
``<module>.<name>`` for module-level locks), where ``<module>`` is the
dotted path relative to the indexed root — e.g.
``gie_tpu_torch.metricsio.engine.ScrapeEngine._lock``. These names are the
vocabulary of ``lockorder.toml`` and of the dynamic tracker.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional

_LOCK_FACTORIES = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
}

# Builtins whose calls the analyzers care about (float() on a CUDA tensor
# is a host sync; print() in a captured graph runs at capture only).
_BUILTINS = {"float", "int", "bool", "print", "open", "len", "str"}

# What the index infers to be a tensor ("torch.Tensor"): an annotation
# naming it, a call of one of these torch functions, a tensor method that
# returns a tensor, or a subscript of a tensor. Type-qualified rules
# (``torch.Tensor.item`` in ``[d2h]``) match only such receivers, so a
# numpy array's ``.tolist()`` is never taken for a device pull.
TENSOR = "torch.Tensor"
_TENSOR_FUNCS = frozenset("torch." + f for f in (
    "tensor", "as_tensor", "from_numpy", "zeros", "ones", "empty", "full",
    "zeros_like", "ones_like", "empty_like", "full_like", "arange",
    "linspace", "rand", "randn", "randint", "stack", "cat", "where",
    "clamp", "minimum", "maximum", "exp", "log", "sqrt", "abs", "sum",
    "amax", "amin", "argmax", "argmin", "cumsum", "gather", "einsum",
    "matmul", "topk", "sort", "argsort", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_left_shift", "bitwise_right_shift", "nonzero",
    "unique", "masked_select", "isfinite", "searchsorted", "bucketize"))
_TENSOR_METHODS = frozenset((
    "to", "cuda", "cpu", "clone", "contiguous", "detach", "float", "int",
    "long", "bool", "view", "reshape", "expand", "flatten", "squeeze",
    "unsqueeze", "permute", "transpose", "t", "sum", "amax", "amin", "max",
    "min", "abs", "clamp", "gather", "index_select", "masked_fill",
    "copy_", "zero_", "fill_", "add_", "mul_", "pin_memory", "narrow"))
# Other torch calls whose result type the rules need.
_TORCH_RETURNS = {
    "torch.cuda.current_stream": "torch.cuda.Stream",
    "torch.cuda.default_stream": "torch.cuda.Stream",
}


def body_nodes(root: ast.AST):
    """Walk an AST subtree without descending into nested function/class
    definitions (their bodies execute on a different call, not here).
    ``ast.walk`` cannot be pruned — a bare ``continue`` still yields the
    nested body's children, mis-attributing a closure's calls/locks to
    the enclosing function."""
    stack = [root]
    first = True
    while stack:
        node = stack.pop()
        if not first and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                       ast.ClassDef)):
            continue
        first = False
        yield node
        stack.extend(ast.iter_child_nodes(node))


@dataclass(frozen=True)
class Violation:
    rule: str
    file: str          # path relative to the analysis root
    line: int
    qualname: str      # enclosing function/class scope, or "<module>"
    message: str

    @property
    def where(self) -> str:
        return f"{self.file}:{self.qualname}"

    def render(self) -> str:
        return (f"{self.file}:{self.line}: {self.rule} [{self.qualname}] "
                f"{self.message}")


@dataclass
class LockDef:
    name: str          # dotted address (see module docstring)
    kind: str          # lock | rlock | condition
    file: str
    line: int


@dataclass
class CallSite:
    node: ast.Call
    # Exactly one of the following is set:
    target: Optional["FunctionInfo"] = None   # resolved in-tree function
    ext: Optional[str] = None                 # dotted external name
    method: Optional[str] = None              # unresolved attribute call
    recv: Optional[ast.expr] = None           # receiver expr (methods)


@dataclass
class FunctionInfo:
    qualname: str                   # "Class.method" or "func"
    module: "ModuleInfo"
    node: ast.AST                   # FunctionDef / AsyncFunctionDef
    cls: Optional["ClassInfo"] = None
    calls: dict = field(default_factory=dict)      # id(Call) -> CallSite
    withs: dict = field(default_factory=dict)  # id(With) -> [LockDef...]
    # Transitive summaries (filled by RepoIndex._summarize):
    #   lock name -> (line, chain-string)
    acquires: dict = field(default_factory=dict)
    #   blocking-desc -> (line, chain-string)
    blocks: dict = field(default_factory=dict)

    @property
    def where(self) -> str:
        return f"{self.module.file}:{self.qualname}"


@dataclass
class ClassInfo:
    name: str
    module: "ModuleInfo"
    node: ast.ClassDef
    bases: list = field(default_factory=list)       # ClassInfo | str
    methods: dict = field(default_factory=dict)     # name -> FunctionInfo
    attr_types: dict = field(default_factory=dict)  # attr -> ClassInfo|str
    locks: dict = field(default_factory=dict)       # attr -> LockDef

    @property
    def dotted(self) -> str:
        return f"{self.module.modname}.{self.name}"

    def find_method(self, name: str) -> Optional[FunctionInfo]:
        if name in self.methods:
            return self.methods[name]
        for b in self.bases:
            if isinstance(b, ClassInfo):
                m = b.find_method(name)
                if m is not None:
                    return m
        return None

    def find_lock(self, attr: str) -> Optional[LockDef]:
        if attr in self.locks:
            return self.locks[attr]
        for b in self.bases:
            if isinstance(b, ClassInfo):
                d = b.find_lock(attr)
                if d is not None:
                    return d
        return None

    def find_attr_type(self, attr: str):
        if attr in self.attr_types:
            return self.attr_types[attr]
        for b in self.bases:
            if isinstance(b, ClassInfo):
                t = b.find_attr_type(attr)
                if t is not None:
                    return t
        return None


@dataclass
class ModuleInfo:
    file: str                       # relpath from the analysis root
    modname: str                    # dotted module name
    tree: ast.Module
    imports: dict = field(default_factory=dict)     # alias -> dotted module
    from_names: dict = field(default_factory=dict)  # name -> dotted target
    classes: dict = field(default_factory=dict)
    functions: dict = field(default_factory=dict)   # module-level funcs
    locks: dict = field(default_factory=dict)       # module-level locks


def dotted_name(expr: ast.expr) -> Optional[str]:
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return None


def _ann_to_dotted(ann: ast.expr) -> Optional[str]:
    """Annotation expression -> dotted type name. Optional[T] unwraps to
    T; string annotations parse; anything fancier resolves to None."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, ast.Subscript):
        base = dotted_name(ann.value)
        if base in ("Optional", "typing.Optional"):
            return _ann_to_dotted(ann.slice)
        return None
    return dotted_name(ann)


class _Scope:
    """Per-function resolution context: parameter/local-variable types."""

    def __init__(self):
        self.var_types: dict = {}   # name -> ClassInfo | str (ext dotted)
        self.poisoned: set = set()  # reassigned incompatibly -> unknown


class RepoIndex:
    """Cross-module index over one directory tree of Python files."""

    def __init__(self, root: str, package_prefix: str = ""):
        self.root = os.path.abspath(root)
        self.package_prefix = package_prefix
        self.modules: dict[str, ModuleInfo] = {}      # modname -> info
        self.locks: dict[str, LockDef] = {}           # lock name -> def
        self.parse_errors: list[Violation] = []
        self._files: list[tuple[str, str]] = []       # (relpath, modname)

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, root: str, package_prefix: str = "") -> "RepoIndex":
        idx = cls(root, package_prefix)
        idx._collect_files()
        idx._parse_all()
        idx._index_structure()
        idx._resolve_bodies()
        idx._summarize()
        return idx

    def _collect_files(self) -> None:
        if os.path.isfile(self.root):
            base = os.path.basename(self.root)
            mod = self.package_prefix + os.path.splitext(base)[0]
            self._files.append((base, mod))
            self.root = os.path.dirname(self.root)
            return
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = sorted(
                d for d in dirnames
                if d != "__pycache__" and not d.startswith(".")
            )
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                mod = rel[:-3].replace(os.sep, ".")
                if mod.endswith(".__init__"):
                    mod = mod[: -len(".__init__")]
                self._files.append((rel, self.package_prefix + mod))

    def _parse_all(self) -> None:
        for rel, mod in self._files:
            path = os.path.join(self.root, rel)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    tree = ast.parse(f.read(), filename=rel)
            except SyntaxError as e:
                self.parse_errors.append(Violation(
                    "E000", rel, e.lineno or 0, "<module>",
                    f"syntax error: {e.msg}"))
                continue
            self.modules[mod] = ModuleInfo(file=rel, modname=mod, tree=tree)

    # -- pass 1: structure (imports, classes, locks, attribute types) ------

    @staticmethod
    def _note_import(modname: str, node: ast.AST, imports: dict,
                     from_names: dict) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                imports[(a.asname or a.name.split(".")[0])] = (
                    a.name if a.asname else a.name.split(".")[0])
                if a.asname:
                    imports[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative import -> resolve in-package
                base = modname.split(".")
                base = base[: len(base) - node.level]
                src = ".".join(base + ([node.module]
                                       if node.module else []))
            else:
                src = node.module or ""
            for a in node.names:
                from_names[a.asname or a.name] = f"{src}.{a.name}"

    @classmethod
    def _local_view(cls, mi: ModuleInfo, fn: ast.AST) -> ModuleInfo:
        """`mi` as `fn`'s body sees it: with the imports made inside the
        function merged over the module's (the package imports lazily,
        inside functions, to keep imports cheap and acyclic). Shares every
        table but the two import maps; `mi` itself when there are none."""
        imports: dict = {}
        from_names: dict = {}
        for node in body_nodes(fn):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                cls._note_import(mi.modname, node, imports, from_names)
        if not imports and not from_names:
            return mi
        return dataclasses.replace(
            mi, imports={**mi.imports, **imports},
            from_names={**mi.from_names, **from_names})

    def _index_structure(self) -> None:
        for mi in self.modules.values():
            for node in mi.tree.body:
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    self._note_import(mi.modname, node, mi.imports,
                                      mi.from_names)
                elif isinstance(node, ast.ClassDef):
                    ci = ClassInfo(name=node.name, module=mi, node=node)
                    mi.classes[node.name] = ci
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    mi.functions[node.name] = FunctionInfo(
                        qualname=node.name, module=mi, node=node)
                elif isinstance(node, ast.Assign):
                    self._maybe_module_lock(mi, node)
        # Second sweep: function-local imports (every module's own known),
        # then class internals (bases need every class known).
        for mi in self.modules.values():
            for fi in mi.functions.values():
                fi.module = self._local_view(mi, fi.node)
            for ci in mi.classes.values():
                self._index_class(mi, ci)

    def _maybe_module_lock(self, mi: ModuleInfo, node: ast.Assign) -> None:
        if not (isinstance(node.value, ast.Call)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            return
        kind = self._lock_kind(mi, node.value)
        if kind:
            name = f"{mi.modname}.{node.targets[0].id}"
            d = LockDef(name, kind, mi.file, node.lineno)
            mi.locks[node.targets[0].id] = d
            self.locks[name] = d

    def _lock_kind(self, mi: ModuleInfo, call: ast.Call) -> Optional[str]:
        dn = dotted_name(call.func)
        if dn is None:
            return None
        resolved = self._resolve_dotted_import(mi, dn)
        return _LOCK_FACTORIES.get(resolved or dn)

    def _resolve_dotted_import(self, mi: ModuleInfo,
                               dn: str) -> Optional[str]:
        """Map a dotted name through the module's imports to a canonical
        dotted name (``Lock`` -> ``threading.Lock`` after ``from
        threading import Lock``)."""
        head, _, rest = dn.partition(".")
        if head in mi.from_names:
            base = mi.from_names[head]
            return f"{base}.{rest}" if rest else base
        if head in mi.imports:
            base = mi.imports[head]
            return f"{base}.{rest}" if rest else base
        return None

    def _resolve_class(self, mi: ModuleInfo, dn: str) -> Optional[ClassInfo]:
        """Dotted name (as written in ``mi``) -> ClassInfo, if it names a
        class in the indexed tree."""
        if dn in mi.classes:
            return mi.classes[dn]
        resolved = self._resolve_dotted_import(mi, dn) or dn
        modname, _, cls = resolved.rpartition(".")
        m = self.modules.get(modname)
        if m and cls in m.classes:
            return m.classes[cls]
        # `mod.Class` where mod is an in-tree module imported whole.
        if m is None and resolved in (
                mi.modname,):  # pragma: no cover - defensive
            return None
        return None

    def _index_class(self, mi: ModuleInfo, ci: ClassInfo) -> None:
        for b in ci.node.bases:
            dn = dotted_name(b)
            if dn is None:
                continue
            target = self._resolve_class(mi, dn)
            ci.bases.append(target if target is not None else dn)
        for node in ci.node.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                view = self._local_view(mi, node)
                fi = FunctionInfo(
                    qualname=f"{ci.name}.{node.name}", module=view,
                    node=node, cls=ci)
                ci.methods[node.name] = fi
                self._harvest_attrs(view, ci, node)
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name):
                t = self._type_from_ann(mi, node.annotation)
                if t is not None:
                    ci.attr_types.setdefault(node.target.id, t)

    def _type_from_ann(self, mi: ModuleInfo, ann: ast.expr):
        dn = _ann_to_dotted(ann)
        if dn is None:
            return None
        target = self._resolve_class(mi, dn)
        if target is not None:
            return target
        return self._resolve_dotted_import(mi, dn) or dn

    def _type_from_value(self, mi: ModuleInfo, value: ast.expr):
        """Infer a type from an assigned value: constructor calls only."""
        if not isinstance(value, ast.Call):
            return None
        dn = dotted_name(value.func)
        if dn is None:
            return None
        target = self._resolve_class(mi, dn)
        if target is not None:
            return target
        resolved = self._resolve_dotted_import(mi, dn) or dn
        if resolved in _TENSOR_FUNCS:
            return TENSOR
        if resolved in _TORCH_RETURNS:
            return _TORCH_RETURNS[resolved]
        # Constructor-looking externals (dotted, Capitalized last part).
        last = resolved.rpartition(".")[2]
        if last[:1].isupper():
            return resolved
        return None

    def _harvest_attrs(self, mi: ModuleInfo, ci: ClassInfo,
                       fn: ast.AST) -> None:
        """Record ``self.x = ...`` attribute types and lock definitions."""
        args = fn.args
        ann_by_param = {}
        for a in list(args.posonlyargs) + list(args.args) + list(
                args.kwonlyargs):
            if a.annotation is not None:
                t = self._type_from_ann(mi, a.annotation)
                if t is not None:
                    ann_by_param[a.arg] = t
        for node in ast.walk(fn):
            target = None
            value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                target, value = node.target, node.value
            if not (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                continue
            attr = target.attr
            if isinstance(value, ast.Call):
                kind = self._lock_kind(mi, value)
                if kind:
                    name = f"{ci.dotted}.{attr}"
                    if attr not in ci.locks:
                        d = LockDef(name, kind, mi.file, node.lineno)
                        ci.locks[attr] = d
                        self.locks[name] = d
                    continue
            t = None
            if isinstance(node, ast.AnnAssign):
                t = self._type_from_ann(mi, node.annotation)
            if t is None and value is not None:
                t = self._type_from_value(mi, value)
            if t is None and isinstance(value, ast.Name):
                t = ann_by_param.get(value.id)
            if t is not None:
                prev = ci.attr_types.get(attr)
                if prev is None:
                    ci.attr_types[attr] = t
                elif prev is not t and prev != t:
                    # Conflicting assignments -> unknowable.
                    ci.attr_types[attr] = None

    # -- pass 2: function bodies (call sites, with-lock blocks) ------------

    def all_functions(self):
        for mi in self.modules.values():
            for fi in mi.functions.values():
                yield fi
            for ci in mi.classes.values():
                for fi in ci.methods.values():
                    yield fi

    def _resolve_bodies(self) -> None:
        for fi in self.all_functions():
            self._resolve_function(fi)

    def _build_scope(self, fi: FunctionInfo) -> _Scope:
        scope = _Scope()
        args = fi.node.args
        params = list(args.posonlyargs) + list(args.args) + list(
            args.kwonlyargs)
        for a in params:
            if a.annotation is not None:
                t = self._type_from_ann(fi.module, a.annotation)
                if t is not None:
                    scope.var_types[a.arg] = t
        if fi.cls is not None and params and params[0].arg == "self":
            scope.var_types["self"] = fi.cls
        # Simple local aliases: `x = self.attr` / `x = Ctor(...)`. A name
        # assigned twice with different inferred types is dropped.
        for node in ast.walk(fi.node):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            if name in scope.poisoned:
                continue
            t = self._expr_type(node.value, fi, scope)
            prev = scope.var_types.get(name)
            if t is None:
                if prev is not None:
                    scope.poisoned.add(name)
                    scope.var_types.pop(name, None)
                continue
            if prev is None:
                scope.var_types[name] = t
            elif prev is not t and prev != t:
                scope.poisoned.add(name)
                scope.var_types.pop(name, None)
        return scope

    def _expr_type(self, expr: ast.expr, fi: FunctionInfo, scope: _Scope):
        """Type of an expression: ClassInfo, ext dotted str, or None."""
        if isinstance(expr, ast.Name):
            return scope.var_types.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base_t = self._expr_type(expr.value, fi, scope)
            if isinstance(base_t, ClassInfo):
                return base_t.find_attr_type(expr.attr)
            if isinstance(base_t, str):
                return f"{base_t}.{expr.attr}"
            return None
        if isinstance(expr, ast.Call):
            t = self._type_from_value(fi.module, expr)
            if (t is None and isinstance(expr.func, ast.Attribute)
                    and expr.func.attr in _TENSOR_METHODS
                    and self._expr_type(expr.func.value, fi, scope) == TENSOR):
                return TENSOR
            return t
        if isinstance(expr, ast.Subscript):
            if self._expr_type(expr.value, fi, scope) == TENSOR:
                return TENSOR
        return None

    def _resolve_function(self, fi: FunctionInfo) -> None:
        scope = self._build_scope(fi)
        fi._scope = scope  # used by rule passes for lock-expr resolution
        fi._with_nodes = {}
        # Calls inside nested defs only run when the nested function
        # runs — body_nodes prunes those subtrees so they never pollute
        # this function's own summary.
        for node in body_nodes(fi.node):
            if isinstance(node, ast.Call):
                fi.calls[id(node)] = self._resolve_call(node, fi, scope)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                # EVERY resolved lock item is recorded — `with a, b:`
                # acquires both, and the order check must see both.
                locks = [
                    lock for item in node.items
                    if (lock := self.resolve_lock_expr(
                        item.context_expr, fi, scope)) is not None
                ]
                if locks:
                    fi.withs[id(node)] = locks
                    fi._with_nodes[id(node)] = node

    def _resolve_call(self, call: ast.Call, fi: FunctionInfo,
                      scope: _Scope) -> CallSite:
        func = call.func
        mi = fi.module
        if isinstance(func, ast.Name):
            name = func.id
            if name in mi.functions:
                return CallSite(call, target=mi.functions[name])
            if name in mi.classes:
                ctor = mi.classes[name].find_method("__init__")
                if ctor:
                    return CallSite(call, target=ctor)
                return CallSite(call, ext=mi.classes[name].dotted)
            resolved = self._resolve_dotted_import(mi, name)
            if resolved:
                t = self._lookup_tree_function(resolved)
                if t is not None:
                    return CallSite(call, target=t)
                return CallSite(call, ext=resolved)
            if name in _BUILTINS:
                return CallSite(call, ext=name)
            return CallSite(call, ext=name)
        if isinstance(func, ast.Attribute):
            # Typed receiver?
            recv_t = self._expr_type(func.value, fi, scope)
            if isinstance(recv_t, ClassInfo):
                m = recv_t.find_method(func.attr)
                if m is not None:
                    return CallSite(call, target=m)
                return CallSite(call, method=func.attr, recv=func.value)
            if isinstance(recv_t, str):
                return CallSite(call, ext=f"{recv_t}.{func.attr}",
                                method=func.attr, recv=func.value)
            dn = dotted_name(func)
            if dn is not None:
                resolved = self._resolve_dotted_import(mi, dn)
                if resolved:
                    t = self._lookup_tree_function(resolved)
                    if t is not None:
                        return CallSite(call, target=t)
                    return CallSite(call, ext=resolved)
                # Unimported dotted name (e.g. attribute chains on
                # locals): fall through to method matching.
            return CallSite(call, method=func.attr, recv=func.value)
        return CallSite(call)

    def _lookup_tree_function(self, dotted: str):
        modname, _, name = dotted.rpartition(".")
        m = self.modules.get(modname)
        if m is None:
            return None
        if name in m.functions:
            return m.functions[name]
        if name in m.classes:
            return m.classes[name].find_method("__init__")
        return None

    def resolve_lock_expr(self, expr: ast.expr, fi: FunctionInfo,
                          scope: Optional[_Scope] = None
                          ) -> Optional[LockDef]:
        """``with <expr>:`` -> LockDef when the expr names a known lock."""
        scope = scope if scope is not None else getattr(fi, "_scope", None)
        if scope is None:
            return None
        if isinstance(expr, ast.Name):
            t = scope.var_types.get(expr.id)
            if isinstance(t, LockDef):  # pragma: no cover - future-proof
                return t
            if expr.id in fi.module.locks:
                return fi.module.locks[expr.id]
            dn = self._resolve_dotted_import(fi.module, expr.id)
            if dn and dn in self.locks:
                return self.locks[dn]
            return None
        if isinstance(expr, ast.Attribute):
            base_t = self._expr_type(expr.value, fi, scope)
            if isinstance(base_t, ClassInfo):
                return base_t.find_lock(expr.attr)
            dn = dotted_name(expr)
            if dn is not None:
                resolved = self._resolve_dotted_import(fi.module, dn) or dn
                if resolved in self.locks:
                    return self.locks[resolved]
        return None

    # -- pass 3: transitive summaries --------------------------------------

    def _summarize(self) -> None:
        funcs = list(self.all_functions())
        # Direct facts.
        for fi in funcs:
            for wid, locks in fi.withs.items():
                node = fi._with_nodes[wid]
                for lock in locks:
                    fi.acquires.setdefault(lock.name, (node.lineno, ""))
        # Fixpoint over the call graph: who may acquire what. Blocking
        # summaries are computed by the rule passes (they depend on the
        # configured denylist); acquisition is config-independent.
        changed = True
        while changed:
            changed = False
            for fi in funcs:
                for cs in fi.calls.values():
                    if cs.target is None or cs.target is fi:
                        continue
                    for lname, (line, chain) in cs.target.acquires.items():
                        if lname not in fi.acquires:
                            via = cs.target.where
                            sub = f" -> {chain}" if chain else ""
                            fi.acquires[lname] = (
                                cs.node.lineno, f"{via}{sub}")
                            changed = True

