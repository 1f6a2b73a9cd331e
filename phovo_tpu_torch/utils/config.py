"""Per-level setting schedule and its YAML files (torch port of
phovo_tpu/utils/config.py).

The same fields and defaults as phovo_tpu's PhovoConfig, so one schedule
can drive both packages: PhovoConfig.from_dict(dataclasses.asdict(cfg))
carries a phovo_tpu config across, and load_config reads the same files
(the shipped presets under phovo_tpu/configs/, native schema, and the
reference's OpenCV FileStorage schema with its `%YAML:1.0` header and
"... (at each level)" keys). Lists are indexed by pyramid level; levels
with max_iterations 0 are skipped (state passes through). The files are
read by this module's own reader (parse_config_text), not pyyaml: the
port's machines need not have it.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

from phovo_tpu_torch.ops.robust import LOSSES
from phovo_tpu_torch.solvers.trust_region import TROptions

# reference key -> (our field, element type)
_KEYMAP = {
    "numOptimizationLevels": ("num_levels", int),
    "blurFilterSize (at each level)": ("blur_filter_sizes", int),
    "imageGradientsScalingFactor (at each level)": ("gradient_scales", float),
    "lambda_optimization_step (at each level)": ("lambda_steps", float),
    "max_num_iterations (at each level)": ("max_iterations", int),
    "min_gradient_norm (at each level)": ("min_gradient_norms", float),
    "visualizeIterations": ("visualize_iterations", bool),
    "function_tolerance (at each level)": ("function_tolerances", float),
    "gradient_tolerance (at each level)": ("gradient_tolerances", float),
    "parameter_tolerance (at each level)": ("parameter_tolerances", float),
    "initial_trust_region_radius (at each level)": ("initial_trust_region_radii", float),
    "max_trust_region_radius (at each level)": ("max_trust_region_radii", float),
    "min_trust_region_radius (at each level)": ("min_trust_region_radii", float),
    "min_relative_decrease (at each level)": ("min_relative_decreases", float),
    "num_threads": ("num_threads", int),
    "num_linear_solver_threads": ("num_linear_solver_threads", int),
    "minimizer_progress_to_stdout": ("progress_to_stdout", bool),
}


@dataclasses.dataclass(frozen=True)
class PhovoConfig:
    num_levels: int = 5
    blur_filter_sizes: tuple[int, ...] = (0, 0, 0, 0, 0)
    blur_type: str = "gaussian"  # 'gaussian' (sigma 3) | 'box', applied twice
    gradient_scales: tuple[float, ...] = (0.0625,) * 5
    max_iterations: tuple[int, ...] = (0, 0, 5, 20, 50)
    visualize_iterations: bool = False
    min_depth: float = 0.3
    max_depth: float = 5.0
    # Gauss-Newton (analytic / bi-objective)
    lambda_steps: tuple[float, ...] = (1.0,) * 5
    min_gradient_norms: tuple[float, ...] = (300.0,) * 5
    # Trust-region (autodiff / "ceres")
    function_tolerances: tuple[float, ...] | None = None
    gradient_tolerances: tuple[float, ...] | None = None
    parameter_tolerances: tuple[float, ...] | None = None
    initial_trust_region_radii: tuple[float, ...] | None = None
    max_trust_region_radii: tuple[float, ...] | None = None
    min_trust_region_radii: tuple[float, ...] | None = None
    min_relative_decreases: tuple[float, ...] | None = None
    num_threads: int = 1
    num_linear_solver_threads: int = 1
    progress_to_stdout: bool = False
    sampling: str = "nearest"  # 'nearest' | 'bilinear'
    gradient_at: str = "warped"  # 'warped' | 'source' | 'esm'
    robust_loss: str = "none"  # one of ops.robust.LOSSES
    robust_delta: float = 0.1
    # sampling-matmul precision of the TPU kernels; the port computes in f32
    # whatever it says
    mix_mode: str = "bf16x2g"

    def trust_region_options(self, level: int) -> TROptions:
        """The trust-region schedule at one level; unset fields take
        TROptions' defaults."""

        def get(field, default):
            v = getattr(self, field)
            return default if v is None else v[level]

        return TROptions(
            max_iterations=self.max_iterations[level],
            function_tolerance=get("function_tolerances", 1e-6),
            gradient_tolerance=get("gradient_tolerances", 1e-10),
            parameter_tolerance=get("parameter_tolerances", 1e-8),
            initial_trust_region_radius=get("initial_trust_region_radii", 1e4),
            max_trust_region_radius=get("max_trust_region_radii", 1e16),
            min_trust_region_radius=get("min_trust_region_radii", 1e-32),
            min_relative_decrease=get("min_relative_decreases", 1e-3),
        )

    def validate(self) -> "PhovoConfig":
        for f in (
            "blur_filter_sizes", "gradient_scales", "max_iterations",
            "lambda_steps", "min_gradient_norms",
        ):
            v = getattr(self, f)
            if v is not None and len(v) != self.num_levels:
                raise ValueError(
                    f"{f} has {len(v)} entries, expected num_levels={self.num_levels}"
                )
        choices = {
            "robust_loss": LOSSES,
            "sampling": ("nearest", "bilinear"),
            "gradient_at": ("warped", "source", "esm"),
            "blur_type": ("gaussian", "box"),
            "mix_mode": ("f32", "bf16x2g", "bf16x2", "bf16"),
        }
        for f, allowed in choices.items():
            if getattr(self, f) not in allowed:
                raise ValueError(
                    f"{f}={getattr(self, f)!r}; expected one of {allowed}"
                )
        return self

    @classmethod
    def from_dict(cls, d: dict) -> "PhovoConfig":
        """Config from field names to values (lists become tuples); an
        unknown field raises, so a schedule is never half carried over."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"unknown PhovoConfig fields: {unknown}")
        kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return cls(**kwargs).validate()


# YAML 1.1's implicit scalar types as pyyaml resolves them (its
# resolver.py), for the plain scalars of the config subset: bools, nulls,
# decimal ints and floats. A float needs a dot, and an exponent a sign, so
# '1e-4' stays a string (and _FIELD_TYPES coerces it). Other YAML 1.1 int
# forms (binary, octal, hex, sexagesimal) are outside the subset.
_YAML_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_YAML_NULL = ("", "~", "null", "Null", "NULL")
_YAML_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_YAML_OTHER_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+|[1-9][0-9_]*(?::[0-5]?[0-9])+)")
_YAML_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
)
_YAML_SPECIAL_FLOAT = {
    **dict.fromkeys((".inf", ".Inf", ".INF", "+.inf", "+.Inf", "+.INF"), float("inf")),
    **dict.fromkeys(("-.inf", "-.Inf", "-.INF"), float("-inf")),
    **dict.fromkeys((".nan", ".NaN", ".NAN"), float("nan")),
}
# a plain scalar of the subset: no YAML indicator first, no flow or quote
# characters inside
_PLAIN = re.compile(r"[^-?:,\[\]{}#&*!|>'\"%@`\s][^,\[\]{}'\"]*|-[^\s,\[\]{}'\"][^,\[\]{}'\"]*")


class _Line:
    """A cursor over one line of a config file, for error messages."""

    def __init__(self, number: int, text: str):
        self.number, self.text, self.pos = number, text, 0

    def fail(self, why: str) -> ValueError:
        return ValueError(f"config line {self.number}: {why}: {self.text.strip()!r}")

    def skip_space(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def at_end(self) -> bool:
        """Past the last token: the end of the line, or a comment (a '#'
        after whitespace or at the start)."""
        self.skip_space()
        return self.pos >= len(self.text) or (
            self.text[self.pos] == "#" and (self.pos == 0 or self.text[self.pos - 1] in " \t"))


def _plain_scalar(text: str, line: _Line):
    """A plain (unquoted) scalar's value as pyyaml's safe_load types it."""
    if text in _YAML_BOOL:
        return _YAML_BOOL[text]
    if text in _YAML_NULL:
        return None
    if text in _YAML_SPECIAL_FLOAT:
        return _YAML_SPECIAL_FLOAT[text]
    if _YAML_INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _YAML_FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _YAML_OTHER_INT.fullmatch(text):
        raise line.fail("a binary, octal, hex or sexagesimal number is outside the config subset")
    if not _PLAIN.fullmatch(text) or ": " in text or " #" in text:
        raise line.fail(f"{text!r} is not a scalar of the config subset")
    return text


def _scalar(line: _Line, stops: str):
    """The scalar at the cursor: quoted ('...' with '' for a quote, or
    "..." without backslashes), or plain up to one of `stops`, a comment or
    the end of the line; the cursor moves past it."""
    line.skip_space()
    text = line.text
    if line.pos < len(text) and text[line.pos] in "'\"":
        quote = text[line.pos]
        out, k = [], line.pos + 1
        while True:
            end = text.find(quote, k)
            if end < 0:
                raise line.fail("unterminated quoted scalar")
            out.append(text[k:end])
            if quote == "'" and text.startswith("''", end):
                out.append("'")
                k = end + 2
                continue
            break
        value = "".join(out)
        if quote == '"' and "\\" in value:
            raise line.fail("a backslash escape is outside the config subset")
        line.pos = end + 1
        return value
    start = line.pos
    while line.pos < len(text) and text[line.pos] not in stops:
        if text[line.pos] == "#" and text[line.pos - 1] in " \t":
            break
        line.pos += 1
    return _plain_scalar(text[start:line.pos].rstrip(), line)


def _value(line: _Line):
    """A mapping value: a scalar, or a flow sequence of scalars."""
    line.skip_space()
    if not line.text.startswith("[", line.pos):
        value = _scalar(line, "")
    else:
        line.pos += 1
        value = []
        line.skip_space()
        if line.text.startswith("]", line.pos):
            line.pos += 1
        else:
            while True:
                line.skip_space()
                if line.pos < len(line.text) and line.text[line.pos] in "[{":
                    raise line.fail("a nested collection is outside the config subset")
                if line.at_end() or line.text[line.pos] in ",]":
                    raise line.fail("an empty item of a flow sequence")
                value.append(_scalar(line, ",]"))
                line.skip_space()
                if line.text.startswith(",", line.pos):
                    line.pos += 1
                elif line.text.startswith("]", line.pos):
                    line.pos += 1
                    break
                else:
                    raise line.fail("a flow sequence must close on its line")
    if not line.at_end():
        raise line.fail("unexpected text after the value")
    return value


def parse_config_text(text: str) -> dict:
    """The mapping of a config file, typed as pyyaml's safe_load types it,
    for the flat subset the shipped presets (phovo_tpu/configs/*.yml) and
    the reference's OpenCV FileStorage files use: `%YAML:1.0` and `---`
    header lines, `#` comments, one `key: value` a line at the left margin
    (keys may hold spaces and parentheses), values plain or quoted
    scalars or one-line flow sequences `[a, b, c]` of them. Anything else
    (indented or continued lines, block sequences, nested or flow
    mappings, anchors, tags, escapes) raises ValueError naming the line; a
    repeated key keeps its last value, as pyyaml does."""
    data: dict = {}
    in_header = True
    for number, raw in enumerate(text.splitlines(), start=1):
        line = _Line(number, raw)
        if line.at_end():
            continue
        if in_header and raw.startswith("%"):
            if not re.fullmatch(r"%YAML:?\s*1\.[01]\s*", raw):
                raise line.fail("only the %YAML 1.x directive is in the config subset")
            continue
        if re.fullmatch(r"---\s*(#.*)?", raw):
            if not in_header:
                raise line.fail("a second document is outside the config subset")
            in_header = False
            continue
        in_header = False
        if raw[0] in " \t":
            raise line.fail("an indented line is outside the config subset")
        if raw[0] == ":":
            raise line.fail("expected 'key: value'")
        key = _scalar(line, ":")
        if not line.text.startswith(":", line.pos) or not (
                line.pos + 1 == len(raw) or raw[line.pos + 1] in " \t"):
            raise line.fail("expected 'key: value'")
        line.pos += 1
        if not isinstance(key, str):
            key = raw[:line.pos - 1].strip()
        data[key] = _value(line)
    return data


def load_config(path: str | Path) -> PhovoConfig:
    """Load a reference-schema or native-schema YAML config file (the
    flat subset parse_config_text reads)."""
    data = parse_config_text(Path(path).read_text())
    if not data:
        raise ValueError(f"config {path} did not parse to a mapping")
    return config_from_dict(data)


# element type of each native-schema field (PyYAML leaves '1e-9'-style
# floats as strings: YAML 1.1 wants a dot in the mantissa, so coerce)
_FIELD_TYPES = {
    "num_levels": int,
    "blur_filter_sizes": int,
    "blur_type": None,
    "gradient_scales": float,
    "max_iterations": int,
    "visualize_iterations": bool,
    "min_depth": float,
    "max_depth": float,
    "lambda_steps": float,
    "min_gradient_norms": float,
    "function_tolerances": float,
    "gradient_tolerances": float,
    "parameter_tolerances": float,
    "initial_trust_region_radii": float,
    "max_trust_region_radii": float,
    "min_trust_region_radii": float,
    "min_relative_decreases": float,
    "num_threads": int,
    "num_linear_solver_threads": int,
    "progress_to_stdout": bool,
    "sampling": None,
    "gradient_at": None,
    "robust_loss": None,
    "robust_delta": float,
    "mix_mode": None,
}


def config_from_dict(data: dict) -> PhovoConfig:
    """Config from a parsed YAML mapping, reference or native keys. Unknown
    keys are ignored (as cv::FileStorage lookups ignore them); schedules
    longer than num_levels are truncated and shorter ones padded with their
    last value, as the reference indexes them by level."""
    kwargs: dict = {}
    for key, value in data.items():
        if key in _KEYMAP:
            field, elem = _KEYMAP[key]
        elif key in _FIELD_TYPES:
            field, elem = key, _FIELD_TYPES[key]
        else:
            continue
        if isinstance(value, (list, tuple)):
            value = tuple(elem(v) if elem else v for v in value)
        elif elem is not None:
            value = elem(value)
        kwargs[field] = value

    n = kwargs.get("num_levels")
    if n is None:
        raise ValueError("config missing numOptimizationLevels / num_levels")
    for field, value in list(kwargs.items()):
        if isinstance(value, tuple) and field.endswith(("s", "radii")):
            if len(value) > n:
                kwargs[field] = value[:n]
            elif 0 < len(value) < n:
                kwargs[field] = value + (value[-1],) * (n - len(value))

    defaults = {
        "blur_filter_sizes": (0,) * n,
        "gradient_scales": (0.0625,) * n,
        "max_iterations": (0,) * n,
        "lambda_steps": (1.0,) * n,
        "min_gradient_norms": (300.0,) * n,
    }
    for field, dval in defaults.items():
        kwargs.setdefault(field, dval)
    return PhovoConfig(**kwargs).validate()


def override_config(cfg: PhovoConfig, **overrides) -> PhovoConfig:
    """Apply CLI-style overrides, skipping None values (unset flags)."""
    kept = {k: v for k, v in overrides.items() if v is not None}
    if not kept:
        return cfg
    return dataclasses.replace(cfg, **kept).validate()


def builtin_config_dir() -> Path:
    """The shipped presets: phovo_tpu/configs/ beside this package (read as
    files; nothing of phovo_tpu is imported)."""
    return Path(__file__).resolve().parents[2] / "phovo_tpu" / "configs"


def load_builtin(name: str) -> PhovoConfig:
    """Load a shipped preset by file stem, e.g.
    'config_5_level_optimization_ceres'."""
    return load_config(builtin_config_dir() / f"{name}.yml")
