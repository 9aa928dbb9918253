"""PolyTOPS configuration interfaces (paper §III-A/B/C).

Two interfaces, mirroring the paper:

* **JSON** (static): ``SchedulerConfig.from_json(dict_or_path)``
  understands the keys shown in paper Listing 2 —
  ``scheduling_strategy.new_variables``, ``ILP_construction`` (per-dim
  ``cost_functions``), ``custom_constraints``, ``fusion``
  (``scheduling_dimension``/``total_distribution``/``stmts_fusion``),
  ``directives`` and ``auto_vectorization``.
* **Python callback** (dynamic, ≙ the paper's C++ dynamic-library
  interface): a callable invoked before each scheduling iteration with
  the full scheduler state; it returns the :class:`DimConfig` to use for
  that dimension (see :func:`isl_style` for the paper's Listing 3).

Predefined strategies: :func:`pluto_style`, :func:`tensor_style`,
:func:`feautrier_style`, :func:`isl_style`, :func:`bigloops_style`.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

#: cost functions the ILP constructor understands (paper §III-A1);
#: configs may additionally reference their own ``new_variables``
KNOWN_COST_FUNCTIONS = ("proximity", "feautrier", "contiguity",
                        "bigLoopsFirst")
FUSION_MODES = ("smart", "max", "no")
DIRECTIVE_TYPES = ("vectorize", "parallel", "sequential")


class ConfigError(ValueError):
    """Malformed JSON configuration (paper Listing 2 interface)."""


@dataclass
class DimConfig:
    """ILP construction recipe for one scheduling dimension."""
    cost_functions: List[str] = field(default_factory=lambda: ["proximity"])
    constraints: List[str] = field(default_factory=list)
    require_parallel: bool = False      # isl-style: demand a parallel dim


@dataclass
class FusionSpec:
    dimension: Union[int, str]           # dim index or 'default'
    total_distribution: bool = False
    groups: Optional[List[List[int]]] = None   # explicit statement groups


@dataclass
class Directive:
    type: str            # 'vectorize' | 'parallel' | 'sequential'
    stmts: List[int]
    iterator: Optional[int] = None       # iterator index (depth) in the stmt


@dataclass
class SchedulerConfig:
    new_variables: List[str] = field(default_factory=list)
    ilp: Dict[Union[int, str], DimConfig] = field(default_factory=dict)
    custom_constraints: Dict[Union[int, str], List[str]] = field(default_factory=dict)
    fusion: List[FusionSpec] = field(default_factory=list)
    directives: List[Directive] = field(default_factory=list)
    auto_vectorize: bool = False
    fusion_mode: str = "smart"           # 'smart' | 'max' | 'no'
    coeff_bound: int = 4
    cst_bound: int = 32
    # paper §IV-C (doitgen): parametric shifting is off by default (as in
    # Pluto); enabling it allows nonzero parameter coefficients in φ
    parametric_shift: bool = False
    # the "C++ interface": called before each iteration; wins over `ilp`
    strategy: Optional[Callable[[Any], DimConfig]] = None
    name: str = "custom"

    # -- resolution --------------------------------------------------------
    def dim_config(self, dim: int, state: Any = None) -> DimConfig:
        if self.strategy is not None and state is not None:
            return self.strategy(state)
        dc = self.ilp.get(dim, self.ilp.get("default", DimConfig()))
        extra = self.custom_constraints.get(dim, self.custom_constraints.get("default", []))
        if extra:
            dc = DimConfig(dc.cost_functions, list(dc.constraints) + list(extra),
                           dc.require_parallel)
        return dc

    def fusion_for(self, dim: int) -> Optional[FusionSpec]:
        for f in self.fusion:
            if f.dimension == dim:
                return f
        for f in self.fusion:
            if f.dimension == "default":
                return f
        return None

    # -- JSON --------------------------------------------------------------
    @staticmethod
    def _dim_key(entry: dict, what: str) -> Union[int, str]:
        dim = entry.get("scheduling_dimension", "default")
        if dim == "default":
            return dim
        if isinstance(dim, bool) or not isinstance(dim, int) or dim < 0:
            raise ConfigError(
                f"{what}: scheduling_dimension must be a non-negative "
                f"integer or 'default', got {dim!r}")
        return dim

    @staticmethod
    def _entries(strat: dict, key: str) -> List[dict]:
        val = strat.get(key, [])
        if not isinstance(val, list):
            raise ConfigError(f"{key} must be a list, got {type(val).__name__}")
        for entry in val:
            if not isinstance(entry, dict):
                raise ConfigError(
                    f"{key} entries must be objects, got {entry!r}")
        return val

    @classmethod
    def from_json(cls, src: Union[str, dict]) -> "SchedulerConfig":
        """Parse the paper-Listing-2 JSON interface.

        ``src`` is a dict (optionally wrapped in ``scheduling_strategy``)
        or a path to a JSON file.  Malformed input raises
        :class:`ConfigError` (a ``ValueError``) with a message naming the
        offending key — never a bare ``KeyError``/``TypeError`` from deep
        inside the scheduler."""
        if isinstance(src, str):
            with open(src) as f:
                data = json.load(f)
        else:
            data = src
        if not isinstance(data, dict):
            raise ConfigError(
                f"configuration must be a JSON object, got {type(data).__name__}")
        strat = data.get("scheduling_strategy", data)
        if not isinstance(strat, dict):
            raise ConfigError("scheduling_strategy must be a JSON object")
        cfg = cls()
        nv = strat.get("new_variables", [])
        if not isinstance(nv, list) or not all(isinstance(v, str) for v in nv):
            raise ConfigError("new_variables must be a list of strings")
        cfg.new_variables = list(nv)
        for entry in cls._entries(strat, "ILP_construction"):
            dim = cls._dim_key(entry, "ILP_construction")
            cfs = entry.get("cost_functions", ["proximity"])
            if not isinstance(cfs, list) or not cfs:
                raise ConfigError(
                    f"ILP_construction[{dim}]: cost_functions must be a "
                    f"non-empty list")
            for cf in cfs:
                if cf not in KNOWN_COST_FUNCTIONS and cf not in cfg.new_variables:
                    raise ConfigError(
                        f"ILP_construction[{dim}]: unknown cost function "
                        f"{cf!r} (known: {', '.join(KNOWN_COST_FUNCTIONS)}, "
                        f"plus declared new_variables)")
            cons = entry.get("constraints", [])
            if not isinstance(cons, list) or not all(isinstance(c, str) for c in cons):
                raise ConfigError(
                    f"ILP_construction[{dim}]: constraints must be a list "
                    f"of strings")
            cfg.ilp[dim] = DimConfig(
                cost_functions=list(cfs),
                constraints=list(cons),
                require_parallel=bool(entry.get("require_parallel", False)),
            )
        for entry in cls._entries(strat, "custom_constraints"):
            dim = cls._dim_key(entry, "custom_constraints")
            cons = entry.get("constraints", [])
            if not isinstance(cons, list) or not all(isinstance(c, str) for c in cons):
                raise ConfigError(
                    f"custom_constraints[{dim}]: constraints must be a "
                    f"list of strings")
            cfg.custom_constraints.setdefault(dim, []).extend(cons)
        for entry in cls._entries(strat, "fusion"):
            dim = entry.get("scheduling_dimension", 0)
            if dim != "default" and (isinstance(dim, bool)
                                     or not isinstance(dim, int) or dim < 0):
                raise ConfigError(
                    f"fusion: scheduling_dimension must be a non-negative "
                    f"integer or 'default', got {dim!r}")
            groups = entry.get("stmts_fusion")
            if groups is not None:
                if not isinstance(groups, list):
                    raise ConfigError("fusion: stmts_fusion must be a list "
                                      "of statement-index lists")
                try:
                    groups = [[int(x) for x in g] for g in groups]
                except (TypeError, ValueError):
                    raise ConfigError(
                        "fusion: stmts_fusion groups must contain "
                        "statement indices") from None
                flat = [i for g in groups for i in g]
                if len(flat) != len(set(flat)):
                    raise ConfigError(
                        "fusion: stmts_fusion groups must be disjoint "
                        f"(got {groups})")
            cfg.fusion.append(
                FusionSpec(
                    dimension=dim,
                    total_distribution=bool(entry.get("total_distribution", False)),
                    groups=groups,
                )
            )
        for entry in cls._entries(strat, "directives"):
            dtype = entry.get("type")
            if dtype not in DIRECTIVE_TYPES:
                raise ConfigError(
                    f"directives: type must be one of {DIRECTIVE_TYPES}, "
                    f"got {dtype!r}")
            stmts = entry.get("stmts", [])
            if isinstance(stmts, (str, int)):
                stmts = [stmts]
            try:
                stmts = [int(x) for x in stmts]
            except (TypeError, ValueError):
                raise ConfigError(
                    f"directives[{dtype}]: stmts must be statement "
                    f"indices, got {entry.get('stmts')!r}") from None
            it = entry.get("iterator")
            if it is not None:
                try:
                    it = int(it)
                except (TypeError, ValueError):
                    raise ConfigError(
                        f"directives[{dtype}]: iterator must be an integer "
                        f"depth or null, got {it!r}") from None
            cfg.directives.append(Directive(dtype, stmts, it))
        cfg.auto_vectorize = bool(strat.get("auto_vectorization", False))
        fm = strat.get("fusion_mode", "smart")
        if fm not in FUSION_MODES:
            raise ConfigError(
                f"fusion_mode must be one of {FUSION_MODES}, got {fm!r}")
        cfg.fusion_mode = fm
        for key, default in (("coeff_bound", 4), ("cst_bound", 32)):
            val = strat.get(key, default)
            if isinstance(val, bool) or not isinstance(val, int) or val < 1:
                raise ConfigError(
                    f"{key} must be a positive integer, got {val!r}")
            setattr(cfg, key, val)
        cfg.parametric_shift = bool(strat.get("parametric_shift", False))
        cfg.name = strat.get("name", "json")
        return cfg

    def to_json(self) -> dict:
        """Listing-2 JSON rendering; loses only the Python ``strategy``
        callback — ``from_json(to_json(cfg))`` reproduces every other
        field exactly (the config round-trip conformance invariant)."""
        out: Dict[str, Any] = {"scheduling_strategy": {}}
        s = out["scheduling_strategy"]
        if self.new_variables:
            s["new_variables"] = self.new_variables
        s["ILP_construction"] = [
            {
                "scheduling_dimension": dim,
                "cost_functions": dc.cost_functions,
                **({"constraints": dc.constraints} if dc.constraints else {}),
                **({"require_parallel": True} if dc.require_parallel else {}),
            }
            for dim, dc in self.ilp.items()
        ]
        if self.custom_constraints:
            s["custom_constraints"] = [
                {"scheduling_dimension": dim, "constraints": list(cons)}
                for dim, cons in self.custom_constraints.items()
            ]
        if self.fusion:
            s["fusion"] = [
                {
                    "scheduling_dimension": f.dimension,
                    "total_distribution": f.total_distribution,
                    **({"stmts_fusion": f.groups} if f.groups else {}),
                }
                for f in self.fusion
            ]
        if self.directives:
            s["directives"] = [
                {"type": d.type, "stmts": d.stmts, "iterator": d.iterator}
                for d in self.directives
            ]
        if self.auto_vectorize:
            s["auto_vectorization"] = True
        s["fusion_mode"] = self.fusion_mode
        s["coeff_bound"] = self.coeff_bound
        s["cst_bound"] = self.cst_bound
        if self.parametric_shift:
            s["parametric_shift"] = True
        s["name"] = self.name
        return out


# ---------------------------------------------------------------------------
# predefined strategies (paper §IV: pluto-style, tensor-scheduler-style,
# isl-style, feautrier-style, bigLoopsFirst)
# ---------------------------------------------------------------------------

def pluto_style(**kw) -> SchedulerConfig:
    cfg = SchedulerConfig(name="pluto-style", **kw)
    cfg.ilp["default"] = DimConfig(cost_functions=["proximity"])
    return cfg


def tensor_style(**kw) -> SchedulerConfig:
    """contiguity first, proximity second, no skewing (paper Listing 5)."""
    cfg = SchedulerConfig(name="tensor-style", **kw)
    cfg.ilp["default"] = DimConfig(
        cost_functions=["contiguity", "proximity"], constraints=["no-skewing"]
    )
    return cfg


def feautrier_style(**kw) -> SchedulerConfig:
    cfg = SchedulerConfig(name="feautrier-style", **kw)
    cfg.ilp["default"] = DimConfig(cost_functions=["feautrier"])
    return cfg


def bigloops_style(**kw) -> SchedulerConfig:
    cfg = SchedulerConfig(name="bigloops-style", **kw)
    cfg.ilp["default"] = DimConfig(cost_functions=["bigLoopsFirst", "proximity"])
    return cfg


def isl_style(**kw) -> SchedulerConfig:
    """Paper Listing 3: Pluto-style by default; when proximity fails to
    extract parallelism at the start of a band, recompute the dimension
    with the Feautrier cost function (dynamic strategy — this is the
    Python analogue of the C++ configuration interface)."""

    def strategy(state) -> DimConfig:
        if state.parallel_failed:
            return DimConfig(cost_functions=["feautrier"])
        if state.band_start:
            return DimConfig(cost_functions=["proximity"], require_parallel=True)
        return DimConfig(cost_functions=["proximity"])

    cfg = SchedulerConfig(name="isl-style", strategy=strategy, **kw)
    return cfg


STRATEGIES: Dict[str, Callable[..., SchedulerConfig]] = {
    "pluto": pluto_style,
    "tensor": tensor_style,
    "feautrier": feautrier_style,
    "isl": isl_style,
    "bigloops": bigloops_style,
}
