"""Arithmetic expression engine over fields, compiled to PyTorch.

Role of the reference arithmetic (src/arithmetic.F90, shunting-yard RPN
evaluator): expressions over scalar fields with `$id:modifier` references
(modifiers src/arithmetic@proc.F90:1049-1105), ~20 math functions, the
chemical function library (gtf/vtf/htf[_kir]/gkin/kkin/lag/elf/vir/he/
lol[_kir], src/arithmetic@proc.F90:2035-2180), and user variables.

Design: instead of an RPN interpreter the expression is rewritten to
Python AST (after desugaring `$field:mod` and `^`), validated against a
whitelist, and compiled once into a closure over batched SoA field
evaluations xT (3, N) -> (N,), f64 tensors on the device of the points.
Field evaluations are cached per (field, nder) inside an evaluation
context so `$1+$1:l` evaluates field 1 once. Ghost-field derivatives come
from torch.autograd (fields/field.py), replacing the reference's
Richardson-extrapolated numerical derivatives
(src/fieldmod@proc.f90:932-1135); the parts evaluated on the host
(closest-nucleus structural variables, $ewald, the one-electron
potentials) raise ExprError when their points need a gradient.
"""
from __future__ import annotations

import ast
import math
import re

import numpy as np
import torch

from . import param
from .config import FDTYPE

__all__ = ["compile_expr", "eval_expr", "eval_const", "ExprError"]

CTF = (3.0 / 10.0) * (3.0 * math.pi ** 2) ** (2.0 / 3.0)


class ExprError(ValueError):
    pass


_MATH = {
    "abs": torch.abs, "exp": torch.exp, "sqrt": torch.sqrt,
    "floor": torch.floor, "ceil": torch.ceil, "ceiling": torch.ceil,
    "round": torch.round, "log": torch.log, "log10": torch.log10,
    "sin": torch.sin, "asin": torch.asin, "cos": torch.cos,
    "acos": torch.acos, "tan": torch.tan, "atan": torch.atan,
    "atan2": torch.atan2, "sinh": torch.sinh, "cosh": torch.cosh,
    "erf": torch.special.erf, "erfc": torch.special.erfc,
    "min": torch.minimum, "max": torch.maximum,
}

_CHEM = ("gtf", "vtf", "htf", "gtf_kir", "vtf_kir", "htf_kir", "gkin",
         "kkin", "lag", "elf", "vir", "he", "lol", "lol_kir",
         # BR-hole / pair-density functions (reference
         # src/arithmetic@proc.F90:2144-2233)
         "brhole_a", "brhole_a1", "brhole_a2", "brhole_b", "brhole_b1",
         "brhole_b2", "brhole_alf", "brhole_alf1", "brhole_alf2",
         "xhcurv", "xhcurv1", "xhcurv2", "dsigs", "dsigs1", "dsigs2",
         "mep", "uslater", "nheff", "xhole", "stress")

_MODS = ("", "v", "c", "x", "y", "z", "g", "xx", "xy", "xz", "yx", "yy",
         "yz", "zx", "zy", "zz", "l", "lv", "lc", "up", "dn", "sp")

_FIELD_RE = re.compile(r"\$(\w+)(?::(\w+))?")
_SVAR_RE = re.compile(r"@(\w+)(?::(\w+))?")

_SVARS = ("dnuc", "xnucx", "ynucx", "znucx", "xnucc", "ynucc", "znucc",
          "xx", "yx", "zx", "xc", "yc", "zc", "xm", "ym", "zm",
          "xxr", "yxr", "zxr", "idnuc", "nidnuc", "rho0nuc", "spcnuc",
          "zatnuc")


def _math_on(device):
    """The math functions with Python numbers lifted to f64 tensors on
    `device` (torch.minimum and friends take tensors only)."""
    def lift(fn):
        def call(*args):
            return fn(*[a if isinstance(a, torch.Tensor) else
                        torch.as_tensor(a, dtype=FDTYPE, device=device)
                        for a in args])
        return call

    return {k: lift(v) for k, v in _MATH.items()}


class _Ctx:
    """Per-batch evaluation context with (field, nder) caching."""

    def __init__(self, system, xT, periodic=True):
        self.system = system
        self.xT = xT
        self.periodic = periodic
        self._cache = {}

    def res(self, fid, nder):
        fid = self.system.resolve_fid(fid)
        for lvl in range(nder, 3):
            if (fid, lvl) in self._cache:
                return self._cache[(fid, lvl)]
        f = self.system.field(fid)
        out = f.eval_fn(nder=nder, clamp_nuclei=False)(self.xT)
        self._cache[(fid, nder)] = out
        return out

    def _host_points(self, what):
        """The points as host numpy (N, 3), for a part evaluated on the
        host; such a part has no derivative."""
        if self.xT.requires_grad:
            raise ExprError(f"{what} is host-evaluated and cannot be used "
                            "inside differentiated/ghost fields")
        return self.xT.detach().cpu().numpy().T

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=FDTYPE,
                               device=self.xT.device)

    # ---- structural variables -----------------------------------------
    def svar(self, name, fder=""):
        """Structural variables @dnuc/@xx/... (reference structvareval,
        src/arithmetic@proc.F90 structural-variable enum and evaluator).
        Geometry-only variables are tensor ops on the points;
        closest-nucleus ones are host-evaluated."""
        name = name.lower()
        if name not in _SVARS:
            raise ExprError(f"unknown structural variable @{name}")
        c = self.system.crystal
        # the reference prints molecule coordinates in the input frame
        # and default units (dunit0(iunit)): Angstrom for molecules
        scale = param.BOHR_TO_ANGSTROM if c.ismolecule else 1.0
        molx0 = np.asarray(c.molx0) if (c.ismolecule and
                                        c.molx0 is not None) else 0.0
        xT = self.xT
        if name in ("xc", "yc", "zc"):
            return xT["xyz".index(name[0])]
        if name in ("xm", "ym", "zm"):
            i = "xyz".index(name[0])
            off = float(molx0[i]) if np.ndim(molx0) else 0.0
            return (xT[i] + off) * scale
        if name in ("xx", "yx", "zx"):
            wx = self._tensor(c.m_c2x) @ xT
            return wx["xyz".index(name[0])]
        if name in ("xxr", "yxr", "zxr"):
            wxr = self._tensor(c.m_x2xr @ c.m_c2x) @ xT
            return wxr["xyz".index(name[0])]
        pts = self._host_points(f"@{name}")
        nid, dist = c.identify_atom(pts, icrd=param.ICRD_CART,
                                    distmax=np.inf)
        if fder:
            ok = nid == int(fder) - 1
        else:
            ok = np.ones(len(nid), bool)
        if name == "dnuc":
            out = dist * scale
        elif name in ("xnucx", "ynucx", "znucx"):
            out = np.asarray(c.x_frac)[nid, "xyz".index(name[0])]
        elif name in ("xnucc", "ynucc", "znucc"):
            i = "xyz".index(name[0])
            off = molx0[i] if np.ndim(molx0) else 0.0
            out = (np.asarray(c.x_cart)[nid, i] + off) * scale
        elif name == "idnuc":
            out = nid + 1.0
        elif name == "nidnuc":
            out = np.asarray(c.spacegroup.orbit_of)[nid] + 1.0
        elif name == "spcnuc":
            out = np.asarray(c.species_of)[nid] + 1.0
        elif name == "zatnuc":
            out = np.asarray([c.species[s].z for s in
                              np.asarray(c.species_of)[nid]], dtype=float)
        else:   # rho0nuc: all-electron atomic density at dist
            from .fields.grid1 import atomic_density_at

            zs = np.asarray([c.species[s].z for s in
                             np.asarray(c.species_of)[nid]])
            out = atomic_density_at(zs, dist, device="cpu")
        return self._tensor(np.where(ok, out, 0.0))

    # ---- field reference with modifier --------------------------------
    def field(self, fid, mod):
        if isinstance(fid, str) and fid.lower() == "ewald" and \
                fid not in self.system.aliases:
            # special field $ewald (reference isspecialfield/
            # specialfieldeval, src/arithmetic@proc.F90:939-946, :2258)
            from .analysis.ewald import ewald_potential

            self._host_points("$ewald")
            return ewald_potential(self.system.crystal,
                                   self.xT.detach().T)
        mod = mod.lower()
        if mod not in _MODS:
            raise ExprError(f"unknown field modifier :{mod}")
        if mod in ("up", "dn", "sp"):
            # spin channels (reference fieldeval up/dn/sp,
            # src/arithmetic@proc.F90; wfn rho2 spin outputs)
            fld = self.system.field(self.system.resolve_fid(fid))
            if fld.type != "wfn":
                raise ExprError(f":{mod} needs a wavefunction field "
                                "providing spin channels")
            r_up, r_dn = fld.wfn.rho_spin_soa(self.xT)
            if mod == "up":
                return r_up
            if mod == "dn":
                return r_dn
            return r_up - r_dn
        if mod in ("", "v", "c"):
            f, _, _ = self.res(fid, 0)
            if mod == "":
                return f
            fv = self._fval(fid)
            return fv if mod == "v" else f - fv
        if mod in ("x", "y", "z", "g"):
            _, gf, _ = self.res(fid, 1)
            if mod == "g":
                return torch.sqrt((gf * gf).sum(0))
            return gf["xyz".index(mod)]
        f, gf, h6 = self.res(fid, 2)
        if mod in ("l", "lv", "lc"):
            if mod == "l":
                return h6[0] + h6[1] + h6[2]
            raise ExprError("valence laplacian needs core-split fields")
        ij = {"xx": 0, "yy": 1, "zz": 2, "xy": 3, "yx": 3, "xz": 4,
              "zx": 4, "yz": 5, "zy": 5}[mod]
        return h6[ij]

    def _fval(self, fid):
        f, _, _ = self.res(fid, 0)
        fld = self.system.field(self.system.resolve_fid(fid))
        env = fld.coreenv
        if env is None:
            return f
        from .fields.promol import promolecular_soa

        cf, _, _ = promolecular_soa(self.xT, env.atpos, env.atspc, env.tab,
                                    nder=0)
        return f - cf

    # ---- chemical functions -------------------------------------------
    def chem(self, name, fid, *extra):
        name = name.lower()
        if name in ("gtf", "vtf", "htf"):
            f, _, h6 = self.res(fid, 2)
            g = CTF * torch.clamp(f, min=0.0) ** (5.0 / 3.0)
            lap = h6[0] + h6[1] + h6[2]
            if name == "gtf":
                return g
            if name == "vtf":
                return 0.25 * lap - 2.0 * g
            return 0.25 * lap - g
        if name in ("gtf_kir", "vtf_kir", "htf_kir", "lol_kir"):
            f, gf, h6 = self.res(fid, 2)
            f0 = torch.clamp(f, min=1e-30)
            lap = h6[0] + h6[1] + h6[2]
            gmod2 = (gf * gf).sum(0)
            g = CTF * f0 ** (5.0 / 3.0) + gmod2 / (72.0 * f0) + lap / 6.0
            if name == "gtf_kir":
                return g
            if name == "vtf_kir":
                return 0.25 * lap - 2.0 * g
            if name == "htf_kir":
                return 0.25 * lap - g
            q = CTF * f0 ** (5.0 / 3.0) / g
            return q / (1.0 + q)
        if name == "lag":
            _, _, h6 = self.res(fid, 2)
            return -0.25 * (h6[0] + h6[1] + h6[2])
        if name in ("gkin", "kkin", "elf", "vir", "he", "lol"):
            fld = self.system.field(self.system.resolve_fid(fid))
            if fld.type == "dftb" and name in ("gkin", "kkin", "elf",
                                               "lol"):
                return self._chem_dftb(name, fid)
            if fld.type != "wfn":
                raise ExprError(
                    f"{name} needs a field providing the kinetic energy "
                    "density (wavefunction fields)")
            return self._chem_wfn(name, fid)
        if name.startswith(("brhole_", "xhcurv", "dsigs")):
            return self._chem_brhole(name, fid)
        if name in ("mep", "uslater", "nheff", "xhole"):
            return self._chem_hole(name, fid, extra)
        if name == "stress":
            fld = self.system.field(self.system.resolve_fid(fid))
            if fld.type != "wfn":
                raise ExprError("stress needs a wavefunction field")
            ex = fld.wfn.extras_soa(self.xT)
            # largest-magnitude eigenvalue of the Schroedinger stress
            # tensor (reference fun_stress)
            from .ops.eig3 import eigvalsh3s

            lam = eigvalsh3s(ex["stress6"])
            return torch.where(lam[2].abs() > lam[0].abs(), lam[2], lam[0])
        raise ExprError(f"unknown chemical function {name}")

    def _chem_brhole(self, name, fid):
        """BR hole parameters / exchange-hole curvature / same-spin pair
        density coefficient (reference src/arithmetic@proc.F90:2144-2233,
        closed-shell assign_bhole_variables branch). The spin-resolved
        _1/_2 variants equal the average for the closed-shell fields this
        package evaluates; spin-polarized fields are rejected."""
        fld = self.system.field(self.system.resolve_fid(fid))
        if fld.type != "wfn":
            raise ExprError(f"{name} needs a wavefunction field")
        if name[-1] in "12" and fld.wfn.wfntyp != "rhf":
            raise ExprError(f"{name}: spin-resolved BR hole needs "
                            "spin-channel data (only rhf supported)")
        ex = fld.wfn.extras_soa(self.xT)
        rhos = 0.5 * ex["rho"]
        laps = 0.5 * (ex["h6"][0] + ex["h6"][1] + ex["h6"][2])
        drhos2 = 0.25 * (ex["grad"] ** 2).sum(0)
        ds = ex["gkin"] - 0.25 * drhos2 / torch.clamp(rhos, min=1e-30)
        quads = (laps - 2.0 * ds) / 6.0
        base = name.rstrip("12")
        if base == "dsigs":
            return ds
        if base == "xhcurv":
            return quads
        from .ops.brhole import bhole

        b, alf, a = bhole(rhos, quads, 1.0)
        return {"brhole_a": a, "brhole_b": b, "brhole_alf": alf}[base]

    def _chem_hole(self, name, fid, extra):
        """MEP / Slater potential / effective hole normalization /
        exchange hole (reference src/arithmetic@proc.F90:2208-2233,
        evaluated through wfn mep/uslater/xhole). They build 1/|r-c|
        integral matrices per point and have no derivative here."""
        fld = self.system.field(self.system.resolve_fid(fid))
        if fld.type != "wfn":
            raise ExprError(f"{name} needs a wavefunction field")
        self._host_points(name)
        pts = self.xT.detach().T
        if name == "mep":
            return fld.wfn.mep(pts)
        if name == "uslater":
            return fld.wfn.uslater(pts)
        if name == "nheff":
            return fld.wfn.uslater(pts, want_nheff=True)[1]
        # xhole(fid, x0, y0, z0): reference point in the input frame
        if len(extra) != 3:
            raise ExprError("xhole requires three arguments for the "
                            "reference point")
        xref = np.asarray([float(v) for v in extra], dtype=float)
        c = self.system.crystal
        if c.ismolecule:
            xref = xref - np.asarray(getattr(c, "molx0", 0.0))
        else:
            xref = np.asarray(c.m_x2c) @ xref
        return fld.wfn.xhole(pts, xref)

    def _chem_dftb(self, name, fid):
        """Kinetic-energy-density functions for DFTB+ fields (the
        reference sets avail_gkin for dftb, src/fieldmod@proc.f90:798)."""
        fld = self.system.field(self.system.resolve_fid(fid))
        c = fld.crystal
        m_c2x = torch.as_tensor(np.asarray(c.m_c2x), dtype=FDTYPE,
                                device=self.xT.device)
        m_x2c = torch.as_tensor(np.asarray(c.m_x2c), dtype=FDTYPE,
                                device=self.xT.device)
        wx = m_c2x @ self.xT
        wx = wx - torch.floor(wx)
        wc = (m_x2c @ wx).T
        _, _, _, gkin = fld.dftb.eval(wc, nder=1)
        if name == "gkin":
            return gkin
        f, gf, h6 = self.res(fid, 2)
        if name == "kkin":
            return gkin - 0.25 * (h6[0] + h6[1] + h6[2])
        if name == "elf":
            f0 = torch.clamp(f, min=1e-30)
            gmod2 = (gf * gf).sum(0)
            ds = gkin - gmod2 / (8.0 * f0)
            q = ds / (CTF * f0 ** (5.0 / 3.0))
            return torch.where(f < 1e-30, 0.0, 1.0 / (1.0 + q * q))
        q = CTF * torch.clamp(f, min=0.0) ** (5.0 / 3.0) / \
            torch.clamp(gkin, min=1e-30)
        return q / (1.0 + q)

    def _chem_wfn(self, name, fid):
        fld = self.system.field(self.system.resolve_fid(fid))
        ex = fld.wfn.extras_soa(self.xT)   # dict with gkin, vir
        f, gf, h6 = self.res(fid, 2)
        if name == "gkin":
            return ex["gkin"]
        if name == "kkin":
            return ex["gkin"] - 0.25 * (h6[0] + h6[1] + h6[2])
        if name == "elf":
            f0 = torch.clamp(f, min=1e-30)
            ds = ex["gkin"] - (gf * gf).sum(0) / (8.0 * f0)
            q = ds / (CTF * f0 ** (5.0 / 3.0))
            return torch.where(f < 1e-30, torch.zeros_like(q),
                               1.0 / (1.0 + q * q))
        if name == "vir":
            return ex["vir"]
        if name == "he":
            return ex["vir"] + ex["gkin"]
        if name == "lol":
            q = CTF * torch.clamp(f, min=0.0) ** (5.0 / 3.0) / \
                torch.clamp(ex["gkin"], min=1e-30)
            return q / (1.0 + q)
        raise ExprError(name)


class _Validator(ast.NodeVisitor):
    ALLOWED = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Call,
               ast.Constant, ast.Name, ast.Load, ast.Add, ast.Sub,
               ast.Mult, ast.Div, ast.Pow, ast.Mod, ast.USub, ast.UAdd,
               ast.Compare, ast.Lt, ast.Gt, ast.LtE, ast.GtE, ast.Eq,
               ast.NotEq)

    def __init__(self, varnames):
        self.varnames = varnames

    def generic_visit(self, node):
        if not isinstance(node, self.ALLOWED):
            raise ExprError(f"disallowed syntax: {type(node).__name__}")
        super().generic_visit(node)

    def visit_Call(self, node):
        if not isinstance(node.func, ast.Name):
            raise ExprError("only simple function calls allowed")
        name = node.func.id
        if name not in _MATH and name.lower() not in _CHEM and \
                name.lower() != "xc" and name not in ("__field__",
                                                      "__svar__"):
            raise ExprError(f"unknown function {name}")
        # the reference grammar has no keyword arguments; rejecting them
        # also closes an eval() escape through unvisited keyword values
        if node.keywords:
            raise ExprError("keyword arguments not allowed")
        for a in node.args:
            self.visit(a)

    def visit_Name(self, node):
        ok = (node.id in ("pi", "e") or node.id in self.varnames
              or node.id == "__field__")
        if not ok:
            raise ExprError(f"unknown variable {node.id}")


def _desugar(expr: str) -> str:
    expr = _FIELD_RE.sub(
        lambda m: f'__field__("{m.group(1)}","{m.group(2) or ""}")', expr)
    # @name structural variables (reference token_structvar parse,
    # src/arithmetic@proc.F90:715-723)
    expr = _SVAR_RE.sub(
        lambda m: f'__svar__("{m.group(1)}","{m.group(2) or ""}")', expr)
    # ^ is exponentiation in the reference grammar
    return expr.replace("^", "**")


def _parse(expr: str, varnames):
    src = _desugar(expr)
    try:
        tree = ast.parse(src, mode="eval")
    except SyntaxError as exc:
        raise ExprError(f"cannot parse expression: {expr!r} ({exc})") from exc
    _Validator(set(varnames)).visit(tree)
    return tree


class _ChemCalls(ast.NodeTransformer):
    """gtf(1) -> __chem__("gtf", 1): chemical function calls go to the
    evaluation context with their field id as a constant."""

    def visit_Call(self, node):
        self.generic_visit(node)
        if isinstance(node.func, ast.Name) and \
                node.func.id.lower() in _CHEM:
            arg = node.args[0] if node.args else ast.Constant(None)
            if isinstance(arg, ast.Constant):
                fid = arg.value
            elif isinstance(arg, ast.Name):
                fid = arg.id
            else:
                raise ExprError("chemical functions take a field id")
            return ast.copy_location(
                ast.Call(func=ast.Name("__chem__", ast.Load()),
                         args=[ast.Constant(node.func.id.lower()),
                               ast.Constant(fid), *node.args[1:]],
                         keywords=[]), node)
        return node


def _xc(*args):
    # xc(rho[, grad][, lap, tau], func_id) - reference fun_xc
    # (src/arithmetic@proc.F90:1609-1646), libxc numbering
    from .ops.xc import xc_eval

    if len(args) < 2:
        raise ExprError("xc() needs field arguments and an id")
    return xc_eval(int(args[-1]), *args[:-1])


def compile_expr(expr: str, system, periodic: bool | None = None):
    """Compile an expression to fn(xT (3, N) f64 tensor) -> (N,) over
    `system`, evaluated on the device of xT."""
    if periodic is None:
        periodic = not system.crystal.ismolecule
    uservars = getattr(system, "vars", {})
    tree = _parse(expr, uservars)
    tree = ast.fix_missing_locations(_ChemCalls().visit(tree))
    code = compile(tree, "<critic2-expr>", "eval")

    def fn(xT):
        ctx = _Ctx(system, xT, periodic=periodic)
        dev = xT.device
        glb = {"__builtins__": {}, "pi": math.pi, "e": math.e, "xc": _xc,
               "__field__": lambda fid, mod: ctx.field(fid, mod),
               "__svar__": lambda nm, fder: ctx.svar(nm, fder),
               "__chem__": lambda nm, fid, *extra: ctx.chem(
                   nm, fid if fid is not None else system.iref or 0,
                   *extra)}
        glb.update(_math_on(dev))
        glb.update({k: torch.as_tensor(float(v), dtype=FDTYPE, device=dev)
                    for k, v in uservars.items()})
        out = eval(code, glb)  # noqa: S307 - AST whitelisted above
        out = torch.as_tensor(out, device=dev).to(FDTYPE)
        return torch.broadcast_to(out, (xT.shape[1],))

    return fn


def eval_const(expr: str, uservars=None) -> float:
    """Validated scalar evaluation with no system/fields (CLI variables).

    Same whitelist as compile_expr; field references and chemical
    functions are rejected since there is nothing to evaluate them on.
    Evaluated with CPU scalars: there is no field to place on a device.
    """
    uservars = dict(uservars or {})
    tree = _parse(expr, uservars)

    def _no_field(*_a):
        raise ExprError("field references need a loaded system")

    glb = {"__builtins__": {}, "pi": math.pi, "e": math.e}
    glb.update(_math_on("cpu"))
    glb.update({name: _no_field for name in _CHEM})
    glb.update({"xc": _no_field, "__field__": _no_field})
    glb.update({k: float(v) for k, v in uservars.items()})
    code = compile(tree, "<critic2-expr>", "eval")
    return float(eval(code, glb))  # noqa: S307 - AST whitelisted above


def eval_expr(expr: str, system, points_cart, periodic=None):
    """Evaluate an expression at Cartesian points (N, 3) -> (N,) f64
    tensor on the system's device (a tensor of points keeps its own)."""
    from .config import resolve_device

    fn = compile_expr(expr, system, periodic=periodic)
    if isinstance(points_cart, torch.Tensor):
        pts = torch.atleast_2d(points_cart.to(FDTYPE))
    else:
        pts = torch.as_tensor(np.atleast_2d(np.asarray(points_cart, float)),
                              dtype=FDTYPE,
                              device=resolve_device(system.device))
    return fn(pts.T)
