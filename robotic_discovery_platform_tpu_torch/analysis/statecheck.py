"""State-machine extraction from source, the port's copy of the
extraction half of the JAX package's ``analysis/statecheck.py``.

``extract_machines(path)`` reads one module's AST and returns its
control-plane state machines: the state-constant definitions,
assignments to the state field, guard comparisons, and calls to
transition-setter methods (the rollout's ``_transition(to)``, the
breaker's ``_trip``), each machine with its transitions (``frm`` a
concrete state, or ``"*"`` where the guards do not pin it; ``to`` a
concrete state, or ``"?"`` for a computed one). ``analysis/explore.py``
compares the edges its schedules witness with the edges extracted here
from the port's ``serving/rollout.py``, ``resilience/breaker.py`` and
``serving/fleet.py``.

The rules that run over the machines (SC001-SC004), their baseline and
the CLI stay the JAX package's: ``tests/test_torch_port_racecheck.py``
runs them over the port.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

#: boolean attributes modeled as two-state membership machines (the
#: fleet's placement flags); their every flip is a membership transition
#: the instrumentation convention says must be counted and journaled
MEMBERSHIP_FIELDS = ("serving", "draining")
#: set attributes modeled as membership-set machines: add/discard is the
#: transition (chip quarantine)
SET_FIELDS = ("_quarantined",)
_SET_MUTATORS = ("add", "discard", "remove", "clear")

#: names that mark a function as time-driven when they appear inside a
#: comparison: an exit edge in such a function is reachable on the clock
#: alone, not only on an external event
_CLOCK_WORDS = re.compile(
    r"clock|monotonic|deadline|timeout|elapsed|expir|cooldown|sustain",
    re.IGNORECASE,
)


# -- extraction data model ---------------------------------------------------


@dataclasses.dataclass
class Transition:
    """One extracted transition site. ``frm`` is a concrete state, or
    ``"*"`` when the enclosing guards do not pin the source state;
    ``to`` is a concrete state or ``"?"`` for a computed target."""

    frm: str
    to: str
    func: str
    line: int
    col: int
    excluded: frozenset = frozenset()  # frm=="*": states ruled OUT

    def may_leave(self, state: str) -> bool:
        """Could this site fire while the machine is in ``state``?"""
        if self.to == state:
            return False
        if self.frm == "*":
            return state not in self.excluded
        return self.frm == state


@dataclasses.dataclass
class Machine:
    """One extracted state machine (module-scoped by field name)."""

    name: str          # "<stem>.<field>"
    kind: str          # "enum" | "level" | "flag" | "set"
    field: str
    states: tuple      # the state universe (enum machines)
    declared: tuple | None  # the STATES-style tuple, when one exists
    initial: str | None
    transitions: list[Transition]
    guarded: dict      # state value -> [lines] it is compared against
    mutators: list     # [(class, func, line, col)] of direct mutations

    def edges(self) -> set[tuple[str, str]]:
        return {(t.frm, t.to) for t in self.transitions}


@dataclasses.dataclass
class _FnInfo:
    cls: str | None
    name: str
    node: ast.AST
    assigns: list = dataclasses.field(default_factory=list)
    # raw (field, value_node, ast_node, include, exclude, seq_from)
    self_calls: list = dataclasses.field(default_factory=list)
    # raw (callee_name, args, ast_node, include, exclude, seq_from)
    counter_ev: bool = False
    journal_ev: bool = False
    notify_ev: bool = False
    clock_cmp: bool = False
    callees: set = dataclasses.field(default_factory=set)


def _const_str(index: dict, node: ast.AST) -> str | None:
    """A state value: a string literal, or a Name/attr resolving to a
    module/class-level uppercase string constant."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    name = None
    if isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Attribute):
        name = node.attr  # e.g. breaker_lib.OPEN, cls.CLOSED
    if name is not None and name.isupper():
        return index.get(name)
    return None


def _dotted(node: ast.AST) -> str:
    """Lossy dotted rendering of an attribute chain (for substring
    tests like "does this receiver mention the journal")."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        parts.append(_dotted(node.func))
    return ".".join(reversed(parts))


def _collect_constants(tree: ast.Module):
    """Module/class-level uppercase string constants, int constants, and
    tuple groups of state constants."""
    consts: dict[str, str] = {}
    int_consts: dict[str, int] = {}
    groups: dict[str, tuple] = {}
    scopes = [tree.body] + [
        n.body for n in tree.body if isinstance(n, ast.ClassDef)
    ]
    for body in scopes:
        for stmt in body:
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                continue
            tgt = stmt.targets[0]
            if not (isinstance(tgt, ast.Name) and tgt.id.isupper()):
                continue
            v = stmt.value
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                consts[tgt.id] = v.value
            elif isinstance(v, ast.Constant) and isinstance(v.value, int):
                int_consts[tgt.id] = v.value
            elif isinstance(v, (ast.Tuple, ast.List)):
                members = []
                for e in v.elts:
                    s = _const_str(consts, e)
                    if s is None:
                        members = None
                        break
                    members.append(s)
                if members:
                    groups[tgt.id] = tuple(members)
    return consts, int_consts, groups


# -- per-function scan -------------------------------------------------------


class _FunctionScanner:
    """Walk one function body tracking guard constraints on candidate
    state fields and straight-line transition sequencing."""

    def __init__(self, info: _FnInfo, consts: dict, setters=None):
        self.info = info
        self.consts = consts
        # fname -> [(field, "param", idx) | (field, "const", value)]:
        # known transition setters, so calls to them advance the
        # straight-line sequence exactly like a direct assignment
        self.setters = setters or {}

    def scan(self) -> None:
        body = getattr(self.info.node, "body", [])
        self._visit_body(body, {}, [None])

    # constraints: field -> (include: frozenset | None, exclude: frozenset)
    def _visit_body(self, stmts, constraints, seq_box) -> None:
        for stmt in stmts:
            self._visit_stmt(stmt, constraints, seq_box)

    def _visit_stmt(self, stmt, constraints, seq_box) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs are their own scan
        if isinstance(stmt, ast.If):
            pos, neg = self._test_constraints(stmt.test)
            self._visit_expr(stmt.test)
            self._visit_body(stmt.body, _merge(constraints, pos), seq_box)
            self._visit_body(stmt.orelse, _merge(constraints, neg), seq_box)
            # past the branch point straight-line sequencing is ambiguous
            if _contains_sites(stmt, self):
                seq_box[0] = None
            return
        if isinstance(stmt, ast.Try):
            self._visit_body(stmt.body, constraints, seq_box)
            for h in stmt.handlers:
                self._visit_body(h.body, constraints, [None])
            self._visit_body(stmt.orelse, constraints, seq_box)
            self._visit_body(stmt.finalbody, constraints, [None])
            return
        if isinstance(stmt, (ast.For, ast.While, ast.With, ast.AsyncWith,
                             ast.AsyncFor)):
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                inner = [None]  # loop re-entry order is not straight-line
            else:
                inner = seq_box
            for field_name in ("test", "iter"):
                sub = getattr(stmt, field_name, None)
                if sub is not None:
                    self._visit_expr(sub)
            self._visit_body(stmt.body, constraints, inner)
            self._visit_body(getattr(stmt, "orelse", []), constraints,
                             [None])
            return
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._record_assign(stmt, constraints, seq_box)
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call):
                self._record_call(sub, constraints, seq_box)
            elif isinstance(sub, ast.Compare):
                self._record_compare(sub)

    def _visit_expr(self, expr) -> None:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                self._record_call(sub, {}, [None])
            elif isinstance(sub, ast.Compare):
                self._record_compare(sub)

    # -- recording -----------------------------------------------------------

    def _attr_field(self, node) -> str | None:
        return node.attr if isinstance(node, ast.Attribute) else None

    def _record_assign(self, stmt, constraints, seq_box) -> None:
        pairs = []
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if (isinstance(tgt, ast.Tuple)
                        and isinstance(stmt.value, ast.Tuple)
                        and len(tgt.elts) == len(stmt.value.elts)):
                    pairs.extend(zip(tgt.elts, stmt.value.elts))
                else:
                    pairs.append((tgt, stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            pairs.append((stmt.target, stmt))  # value node = the AugAssign
        elif stmt.value is not None:
            pairs.append((stmt.target, stmt.value))
        for tgt, value in pairs:
            field = self._attr_field(tgt)
            if field is None:
                continue
            include, exclude = constraints.get(field, (None, frozenset()))
            tag = "aug" if isinstance(value, ast.AugAssign) else "assign"
            self.info.assigns.append(
                (field, tag, value, stmt, include, exclude, seq_box[0]))
            to = None if tag == "aug" else _const_str(self.consts, value)
            if to is not None:
                seq_box[0] = (field, to)

    def _record_call(self, call: ast.Call, constraints, seq_box) -> None:
        f = call.func
        name = None
        if isinstance(f, ast.Attribute):
            name = f.attr
            recv = _dotted(f.value).lower()
            if name in ("inc", "observe"):
                self.info.counter_ev = True
            elif name == "set" and call.args:
                self.info.counter_ev = True
            elif name == "append" and "journal" in recv:
                self.info.journal_ev = True
            elif name == "record_event":
                self.info.journal_ev = True
            if isinstance(f.value, ast.Name) and f.value.id in ("self",
                                                                "cls"):
                self.info.callees.add(name)
                self.info.self_calls.append(
                    (name, list(call.args), call, dict(constraints),
                     seq_box[0]))
        elif isinstance(f, ast.Name):
            name = f.id
            self.info.callees.add(name)
            self.info.self_calls.append(
                (name, list(call.args), call, dict(constraints),
                 seq_box[0]))
        if name and "notify" in name.lower():
            self.info.notify_ev = True
        # a call to a known setter advances the straight-line sequence
        # (self_calls above already captured the PRE-call sequence)
        for field, skind, sval in self.setters.get(name, ()):
            if skind == "const":
                seq_box[0] = (field, sval)
            else:
                to = (_const_str(self.consts, call.args[sval])
                      if 0 <= sval < len(call.args) else None)
                seq_box[0] = (field, to) if to is not None else None
        # set-machine mutations ride the call syntax
        if (isinstance(f, ast.Attribute)
                and f.attr in _SET_MUTATORS
                and isinstance(f.value, ast.Attribute)
                and f.value.attr in SET_FIELDS):
            self.info.assigns.append(
                (f.value.attr, "setmut", call, call, None, frozenset(),
                 None))

    def _record_compare(self, cmp: ast.Compare) -> None:
        if _CLOCK_WORDS.search(ast.dump(cmp)):
            self.info.clock_cmp = True

    # -- guard parsing -------------------------------------------------------

    def _test_constraints(self, test):
        """(positive, negative) constraint maps implied by an if-test."""
        pos: dict = {}
        neg: dict = {}
        comparisons = []
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            comparisons = [v for v in test.values
                           if isinstance(v, ast.Compare)]
        elif isinstance(test, ast.Compare):
            comparisons = [test]
        for cmp in comparisons:
            if len(cmp.ops) != 1:
                continue
            field = self._attr_field(cmp.left)
            if field is None:
                continue
            op = cmp.ops[0]
            comp = cmp.comparators[0]
            values = []
            if isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                for e in comp.elts:
                    s = _const_str(self.consts, e)
                    if s is not None:
                        values.append(s)
            else:
                s = _const_str(self.consts, comp)
                if s is not None:
                    values.append(s)
            if not values:
                continue
            vals = frozenset(values)
            if isinstance(op, (ast.Eq, ast.In)):
                pos[field] = (vals, frozenset())
                if len(comparisons) == 1:
                    neg[field] = (None, vals)
            elif isinstance(op, (ast.NotEq, ast.NotIn)):
                pos[field] = (None, vals)
                if len(comparisons) == 1:
                    neg[field] = (vals, frozenset())
            # record the guard itself for dead-guard detection
            self.guard_hook(field, vals, cmp)
        return pos, neg

    def guard_hook(self, field, vals, node) -> None:
        pass  # bound by the extractor


def _merge(constraints: dict, update: dict) -> dict:
    out = dict(constraints)
    for field, (inc, exc) in update.items():
        inc0, exc0 = out.get(field, (None, frozenset()))
        if inc is not None:
            inc = inc if inc0 is None else (inc & inc0)
            out[field] = (inc, frozenset())
        else:
            out[field] = (inc0, exc0 | exc)
    return out


def _contains_sites(stmt, scanner) -> bool:
    """Does this branch contain anything that could move a machine --
    an attribute assignment or a call to a known setter? If so, the
    straight-line sequence past it is ambiguous."""
    for sub in ast.walk(stmt):
        if isinstance(sub, (ast.Assign, ast.AugAssign)):
            targets = sub.targets if isinstance(sub, ast.Assign) \
                else [sub.target]
            for t in targets:
                if isinstance(t, ast.Attribute):
                    return True
        elif isinstance(sub, ast.Call):
            f = sub.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name in scanner.setters:
                return True
    return False


# -- module extraction -------------------------------------------------------


class ModuleMachines:
    """All machines extracted from one module, plus the per-function
    evidence index the rules run over."""

    def __init__(self, tree: ast.Module, path: str):
        self.path = path
        self.stem = Path(path).stem
        self.consts, self.int_consts, self.groups = _collect_constants(tree)
        self.fns: dict[tuple, _FnInfo] = {}
        self.guards: dict[str, dict[str, list[int]]] = {}
        # pass 1 finds the setter methods; pass 2 re-scans with setter
        # calls advancing the straight-line sequence (rollout's
        # ``_transition(DRAINING)`` chain)
        self._scan(tree, {})
        self.setters = self._setters()
        if self.setters:
            self.fns = {}
            self.guards = {}
            self._scan(tree, self.setters)
        self.machines = self._assemble()

    # -- scanning ------------------------------------------------------------

    def _scan(self, tree: ast.Module, setters: dict) -> None:
        def scan_fn(cls_name, fn_node):
            info = _FnInfo(cls=cls_name, name=fn_node.name, node=fn_node)
            scanner = _FunctionScanner(info, self.consts, setters)
            scanner.guard_hook = self._note_guard
            scanner.scan()
            self.fns[(cls_name, fn_node.name)] = info

        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan_fn(None, node)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        scan_fn(node.name, sub)

    def _note_guard(self, field, vals, node) -> None:
        per = self.guards.setdefault(field, {})
        for v in vals:
            per.setdefault(v, []).append(node.lineno)

    # -- assembly ------------------------------------------------------------

    def _setters(self):
        """func name -> [(field, "param", idx) | (field, "const", val)]:
        methods whose *unguarded* assignment to a state field makes
        every call site a transition site (rollout ``_transition(to)``,
        breaker ``_trip``). A guarded assignment does not qualify --
        calling such a method only MAYBE transitions."""
        out: dict[str, list] = {}
        for (cls, fname), info in self.fns.items():
            if fname == "__init__" or cls is None:
                continue
            args = getattr(info.node, "args", None)
            params = [a.arg for a in args.args] if args else []
            offset = 1 if params[:1] in (["self"], ["cls"]) else 0
            for field, tag, value, node, inc, exc, seq in info.assigns:
                if tag != "assign" or inc is not None or exc:
                    continue
                entry = None
                if isinstance(value, ast.Name) and value.id in params:
                    idx = params.index(value.id) - offset
                    if idx >= 0:
                        entry = (field, "param", idx)
                else:
                    const = _const_str(self.consts, value)
                    if const is not None:
                        entry = (field, "const", const)
                if (entry is not None
                        and entry not in out.setdefault(fname, [])):
                    out[fname].append(entry)
        return out

    def _assemble(self) -> list[Machine]:
        setters = self.setters
        # candidate fields: anything assigned a known string constant,
        # a membership flag (serving/draining), a registered set field
        # (_quarantined), or an int ladder compared against a MAX const
        fields: dict[str, dict] = {}

        def rec_for(field):
            return fields.setdefault(field, {
                "enum_values": set(), "sites": [], "initial": None,
                "flag": False, "set": False, "int": False,
            })

        for (cls, fname), info in self.fns.items():
            for field, tag, value, node, inc, exc, seq in info.assigns:
                line, col = node.lineno, node.col_offset
                if tag == "setmut":
                    if fname == "__init__":
                        continue  # initial seeding, not a transition
                    rec = rec_for(field)
                    rec["set"] = True
                    rec["sites"].append(
                        (fname, "?", line, col, inc, exc, seq, cls))
                    continue
                if tag == "aug":
                    if self._laddered(field):
                        rec = rec_for(field)
                        rec["int"] = True
                        rec["sites"].append(
                            (fname, "?", line, col, inc, exc, seq, cls))
                    continue
                const = _const_str(self.consts, value)
                if const is not None:
                    rec = rec_for(field)
                    rec["enum_values"].add(const)
                    if fname == "__init__":
                        rec["initial"] = const
                    else:
                        rec["sites"].append(
                            (fname, const, line, col, inc, exc, seq, cls))
                    continue
                if field in MEMBERSHIP_FIELDS:
                    is_bool = (isinstance(value, ast.Constant)
                               and isinstance(value.value, bool))
                    rec = rec_for(field)
                    rec["flag"] = True
                    if fname != "__init__":
                        to = (str(value.value).lower() if is_bool
                              else "?")
                        rec["sites"].append(
                            (fname, to, line, col, inc, exc, seq, cls))
                    continue
                if (isinstance(value, ast.Constant)
                        and isinstance(value.value, int)
                        and not isinstance(value.value, bool)
                        and self._laddered(field)):
                    rec = rec_for(field)
                    rec["int"] = True
                    if fname == "__init__":
                        rec["initial"] = str(value.value)
                    else:
                        rec["sites"].append(
                            (fname, str(value.value), line, col, inc, exc,
                             seq, cls))
        # setter call sites become transitions attributed to the caller
        for (cls, fname), info in self.fns.items():
            if fname == "__init__":
                continue
            for callee, cargs, node, constraints, seq in info.self_calls:
                for field, skind, sval in setters.get(callee, ()):
                    ladder = self._laddered(field)
                    if skind == "const":
                        to = sval
                    else:
                        to = None
                        if 0 <= sval < len(cargs):
                            arg = cargs[sval]
                            to = _const_str(self.consts, arg)
                            if (to is None and ladder
                                    and isinstance(arg, ast.Constant)
                                    and isinstance(arg.value, int)
                                    and not isinstance(arg.value, bool)):
                                to = str(arg.value)
                        if to is None:
                            to = "?"
                    rec = rec_for(field)
                    if ladder:
                        rec["int"] = True
                    elif to != "?":
                        rec["enum_values"].add(to)
                    inc, exc = constraints.get(field, (None, frozenset()))
                    rec["sites"].append(
                        (fname, to, node.lineno, node.col_offset, inc, exc,
                         seq, cls))

        machines: list[Machine] = []
        for field, rec in sorted(fields.items()):
            kind = None
            if len(rec["enum_values"]) >= 2:
                kind = "enum"
            elif rec["set"]:
                kind = "set"
            elif rec["flag"]:
                kind = "flag"
            elif rec["int"]:
                kind = "level"
            if kind is None or not rec["sites"]:
                continue
            transitions = []
            for fname, to, line, col, inc, exc, seq, cls in rec["sites"]:
                frm, excluded = "*", frozenset()
                if inc is not None and len(inc) == 1:
                    frm = next(iter(inc))
                elif inc is None and exc:
                    excluded = exc
                if frm == "*" and seq is not None and seq[0] == field:
                    frm = seq[1]
                transitions.append(Transition(
                    frm=frm, to=to if to is not None else "?",
                    func=fname, line=line, col=col, excluded=excluded))
            # mutators: functions DIRECTLY mutating the field (they, not
            # their callers, owe the instrumentation evidence)
            mutators = []
            seen_mut = set()
            for (cls, fname), info in self.fns.items():
                if fname == "__init__" or (cls, fname) in seen_mut:
                    continue
                for f2, tag, value, node, inc, exc, seq in info.assigns:
                    if f2 == field:
                        seen_mut.add((cls, fname))
                        mutators.append((cls, fname, node.lineno,
                                         node.col_offset))
                        break
            declared = None
            if kind == "enum":
                # best-overlap, not superset: a machine that enters one
                # value OUTSIDE its declared tuple must still claim the
                # tuple, or the undeclared-target rule (the whole point)
                # silences itself exactly when it should fire
                best = None
                for gname, members in sorted(self.groups.items()):
                    overlap = len(rec["enum_values"] & set(members))
                    if overlap < 2:
                        continue
                    rank = (overlap, -len(members))
                    if best is None or rank > best[0]:
                        best = (rank, members)
                if best is not None:
                    declared = best[1]
            states = declared or tuple(sorted(
                rec["enum_values"]
                | set(self.guards.get(field, {}))
            ))
            machines.append(Machine(
                name=f"{self.stem}.{field}",
                kind=kind, field=field, states=states,
                declared=declared, initial=rec["initial"],
                transitions=transitions,
                guarded=self.guards.get(field, {}),
                mutators=mutators,
            ))
        return machines

    def _laddered(self, field: str) -> bool:
        """An int field is a brownout-ladder machine when some guard
        compares it against an uppercase integer constant (MAX_LEVEL)."""
        for info in self.fns.values():
            for sub in ast.walk(info.node):
                if not isinstance(sub, ast.Compare):
                    continue
                if not (isinstance(sub.left, ast.Attribute)
                        and sub.left.attr == field):
                    continue
                for comp in sub.comparators:
                    if (isinstance(comp, ast.Name)
                            and comp.id in self.int_consts):
                        return True
        return False

    # -- evidence propagation ------------------------------------------------

    def _resolve_callee(self, info: _FnInfo, name: str):
        return self.fns.get((info.cls, name)) or self.fns.get((None, name))

    def fn_evidence(self, info: _FnInfo) -> tuple[bool, bool, bool]:
        """(counter, journal, notify) for a function, unioned over its
        transitive same-module callees."""
        seen: set = set()
        counter = journal = notify = False
        stack = [info]
        while stack:
            fn = stack.pop()
            key = (fn.cls, fn.name)
            if key in seen:
                continue
            seen.add(key)
            counter |= fn.counter_ev
            journal |= fn.journal_ev
            notify |= fn.notify_ev
            for callee in fn.callees:
                nxt = self._resolve_callee(fn, callee)
                if nxt is not None:
                    stack.append(nxt)
        return counter, journal, notify

    def fn_clocked(self, cls: str | None, fname: str) -> bool:
        """A function is time-driven if it, a direct callee, or a direct
        same-module caller contains a clock/deadline comparison."""
        info = self.fns.get((cls, fname))
        if info is None:
            return False

        def own_or_callee(fn: _FnInfo) -> bool:
            if fn.clock_cmp:
                return True
            return any(
                (nxt := self._resolve_callee(fn, c)) is not None
                and nxt.clock_cmp
                for c in fn.callees
            )

        if own_or_callee(info):
            return True
        for other in self.fns.values():
            if fname in other.callees and own_or_callee(other):
                return True
        return False


# -- public API --------------------------------------------------------------


def extract_machines_from_source(source: str,
                                 path: str = "<memory>") -> list[Machine]:
    """The extracted machines of one module (the explorer and the tests
    build their coverage universe from this)."""
    tree = ast.parse(source, filename=path)
    return ModuleMachines(tree, path).machines


def extract_machines(path: str | Path) -> list[Machine]:
    p = Path(path)
    return extract_machines_from_source(p.read_text(), str(p))
