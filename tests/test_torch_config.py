"""The port's config reader (phovo_tpu_torch/utils/config.py) against
phovo_tpu's pyyaml-based load_config: every shipped preset and the
reference-schema texts of tests/test_config.py give the same PhovoConfig,
with pyyaml importable and with it blocked; scalars and flow sequences are
typed as pyyaml's safe_load types them; anything outside the flat subset
raises ValueError naming its line."""

import dataclasses
import sys
import textwrap

import pytest
import yaml

from phovo_tpu.utils import config as JC
from phovo_tpu_torch.utils import config as TC

PRESETS = sorted(p.stem for p in TC.builtin_config_dir().glob("*.yml"))

# tests/test_config.py's two reference-schema (OpenCV FileStorage) texts
REFERENCE_TEXTS = {
    "analytic": textwrap.dedent("""\
        %YAML:1.0
        numOptimizationLevels: 4
        blurFilterSize (at each level): [0, 0, 0, 0]
        imageGradientsScalingFactor (at each level): [0.0625, 0.0625, 0.0625, 0.0625]
        lambda_optimization_step (at each level): [1,1,1,1]
        max_num_iterations (at each level): [0, 0, 20, 50]
        min_gradient_norm (at each level): [300,300,300,300]
        visualizeIterations: 0
    """),
    "ceres": textwrap.dedent("""\
        %YAML:1.0
        numOptimizationLevels: 2
        blurFilterSize (at each level): [0, 5, 3]
        imageGradientsScalingFactor (at each level): [0.5, 0.5, 0.0625]
        max_num_iterations (at each level): [0, 40, 0]
        function_tolerance (at each level): [1e-4, 1e-4, 1e-4]
        gradient_tolerance (at each level): [1e-3, 1e-3, 1e-3]
        parameter_tolerance (at each level): [1e-4, 1e-4, 1e-6]
        initial_trust_region_radius (at each level): [1e8, 1e4, 1e4]
        max_trust_region_radius (at each level): [1e8, 1e8, 1e8]
        min_trust_region_radius (at each level): [1e-32,1e-32,1e-32]
        min_relative_decrease (at each level): [1e-1,1e-1,1e-3]
        num_threads: 2
        num_linear_solver_threads: 2
        minimizer_progress_to_stdout: 0
        visualizeIterations: 0
    """),
}


@pytest.fixture(params=["pyyaml importable", "pyyaml blocked"])
def yaml_state(request, monkeypatch):
    """Runs a test twice: as it is, and with `import yaml` failing."""
    if request.param == "pyyaml blocked":
        monkeypatch.setitem(sys.modules, "yaml", None)
    return request.param


def _same(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("preset", PRESETS)
def test_every_preset_matches_phovo_tpu(preset, yaml_state):
    ref = JC.load_builtin(preset) if yaml_state == "pyyaml importable" else None
    if ref is None:
        ref = JC.config_from_dict(yaml.safe_load((TC.builtin_config_dir() / f"{preset}.yml").read_text()))
    _same(TC.load_builtin(preset), ref)


def test_the_twelve_presets_are_read():
    assert len(PRESETS) == 12


@pytest.mark.parametrize("schema", sorted(REFERENCE_TEXTS))
def test_reference_schema_matches_phovo_tpu(schema, yaml_state, tmp_path):
    p = tmp_path / f"{schema}.yml"
    p.write_text(REFERENCE_TEXTS[schema])
    ref = JC.config_from_dict(yaml.safe_load(JC._sanitize_opencv_yaml(REFERENCE_TEXTS[schema])))
    _same(TC.load_config(p), ref)


def test_reader_gives_pyyamls_mapping_on_every_preset():
    for preset in PRESETS:
        text = (TC.builtin_config_dir() / f"{preset}.yml").read_text()
        assert TC.parse_config_text(text) == yaml.safe_load(text), preset


SCALARS = [
    "0", "1", "-3", "+4", "1_000", "300", "0.5", ".5", "5.", "-0.0", "0.0625", "1e-4", "1.0e-4", "1.0e4",
    "1E+3", "2.5E-3", "1e8", "true", "True", "FALSE", "yes", "No", "on", "OFF", "~", "null", "", "bilinear",
    "gaussian", "x y", "a(b)", "-abc", ".inf", "-.inf", "'1e-4'", "'it''s'", '"quoted"', "''", "bf16x2g",
]


@pytest.mark.parametrize("scalar", SCALARS)
def test_scalar_typed_as_pyyaml(scalar):
    text = f"key: {scalar}\n"
    got, ref = TC.parse_config_text(text)["key"], yaml.safe_load(text)["key"]
    assert type(got) is type(ref) and got == ref


@pytest.mark.parametrize("value", [
    "[0, 0, 5, 20, 50]", "[1,1,1,1]", "['1e-4', '1e-5']", "[1e-4, 1.0e-4, 0.5]", "[]", "[true, 0, bilinear]",
    "[1, 2]  # a comment", '["a", \'b\']',
])
def test_flow_sequence_typed_as_pyyaml(value):
    text = f"k (at each level): {value}\n"
    got, ref = TC.parse_config_text(text), yaml.safe_load(text)
    assert got == ref
    assert [type(v) for v in got["k (at each level)"]] == [type(v) for v in ref["k (at each level)"]]


def test_comments_headers_and_repeated_keys_as_pyyaml():
    text = "%YAML:1.0\n---\n# a comment\nnum_levels: 2  # trailing\n\nnum_levels: 3\nsampling: nearest\n"
    assert TC.parse_config_text(text) == yaml.safe_load(text.replace("%YAML:1.0\n", ""))


@pytest.mark.parametrize("line", [
    "  indented: 1",
    "- block item",
    "nested: {a: 1}",
    "seq: [1, [2, 3]]",
    "seq: [1, 2",
    "seq: [1, , 2]",
    "no colon here",
    "anchor: &a 5",
    "tag: !!float 5",
    "hex: 0x1f",
    "octal: 017",
    "time: 1:30",
    "escape: \"a\\tb\"",
    "open: 'unterminated",
    "after: [1, 2] trailing",
    "%TAG ! tag:example.com,2000:",
])
def test_line_outside_the_subset_raises_naming_it(line):
    text = f"num_levels: 1\n{line}\n"
    with pytest.raises(ValueError, match="config line 2"):
        TC.parse_config_text(text)


def test_load_config_of_an_empty_file_raises(tmp_path):
    p = tmp_path / "empty.yml"
    p.write_text("# nothing\n")
    with pytest.raises(ValueError, match="did not parse to a mapping"):
        TC.load_config(p)


def test_schedule_padding_as_phovo_tpu(tmp_path, yaml_state):
    p = tmp_path / "short.yml"
    p.write_text("num_levels: 4\nmax_iterations: [5, 10]\n")
    assert TC.load_config(p).max_iterations == (5, 10, 10, 10)


def test_reader_imports_no_yaml():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(TC))
    imported = {alias.name for node in ast.walk(tree) if isinstance(node, (ast.Import, ast.ImportFrom))
                for alias in node.names} | {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    assert "yaml" not in imported
