"""The in-repo YAML subset reader against PyYAML (the reference parser).

Every shipped config must load exactly as PyYAML loads it; constructs
outside the subset must raise instead of loading differently.
"""

import math
from pathlib import Path

import pytest

from vofod_tpu.io.yaml_lite import YamlSubsetError, load_file, loads

CONFIGS = sorted(
    str(p.relative_to(Path(__file__).resolve().parent.parent))
    for p in (Path(__file__).resolve().parent.parent / "configs").rglob("*.yaml")
)
ROOT = Path(__file__).resolve().parent.parent


def _pyyaml(text):
    yaml = pytest.importorskip("yaml")

    class _Loader(yaml.SafeLoader):
        pass

    _Loader.add_constructor(
        "!degrees", lambda loader, node: float(loader.construct_scalar(node))
    )
    return yaml.load(text, Loader=_Loader)


def test_every_config_is_covered():
    assert len(CONFIGS) >= 7


@pytest.mark.parametrize("path", CONFIGS)
def test_config_file_matches_pyyaml(path):
    text = (ROOT / path).read_text()
    assert load_file(str(ROOT / path)) == _pyyaml(text)


@pytest.mark.parametrize(
    "text",
    [
        # the !degrees tag, block and inline
        "sensor:\n  vertical_fov_angle: !degrees 45.0\n  vertical_rays: 64\n",
        "sensor: {vertical_fov_angle: !degrees 90, horizontal_rays: 1024}\n",
        # inline maps, nested, with spaces and an empty map
        "offset: { x: 0.09, y: 0.0, z: -0.75 }\n",
        "a: {b: {c: 1, d: 2.5}, e: true}\nf: {}\n",
        # comments: full-line, trailing, after an inline map, '#' in a word
        "# header\nk: 1 # metres\n\nm: {x: 1} # tail\nn: a#b\n",
        # scalars resolved like YAML 1.1
        "i: 24\nf: 0.1\nneg: -740.0\nexp: 1.0e-3\nb1: false\nb2: yes\n"
        "n1: ~\nn2:\ns: hello world\nq1: 'it''s'\nq2: \"x: y\"\ninf: .inf\n",
        # nesting depth and dedent back to the root
        "a:\n  b:\n    c: 1\n  d: 2\ne: 3\n",
        # an empty document
        "# only a comment\n",
    ],
)
def test_subset_matches_pyyaml(text):
    assert loads(text) == _pyyaml(text)


def test_nan_scalar():
    assert math.isnan(loads("x: .nan\n")["x"])


@pytest.mark.parametrize(
    "text",
    [
        "a:\n  - 1\n  - 2\n",  # block sequence
        "a: [1, 2]\n",  # flow sequence
        "classification: {max_size: [unclosed\n",
        "a: {b: 1\n",  # unclosed flow map
        "a: &anchor 1\nb: *anchor\n",  # anchor / alias
        "a: |\n  text\n",  # block scalar
        "a: !!float 1\n",  # other tags
        "a: !rad 1.0\n",
        "---\na: 1\n",  # document marker
        "a:\n\tb: 1\n",  # tab indentation
        "a: 1\n  b: 2\n",  # bad indentation
        "a: 0x1F\n",  # numeric forms outside the subset
        "a: 010\n",
        "a: 1_000\n",
        "a: b: c\n",
        "a: !degrees north\n",
    ],
)
def test_unsupported_syntax_raises(text):
    with pytest.raises(YamlSubsetError):
        loads(text)


def test_config_path_does_not_import_pyyaml():
    """load_config reads the shipped YAMLs through the subset reader only."""
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "from vofod_tpu.config import load_config\n"
        "cfg, dyn = load_config('configs/detection_params.yaml',"
        " 'configs/sensors/os0-128.yaml', 'configs/apriori_maps/sim.yaml')\n"
        "assert cfg.grid_shape == (51, 201, 241), cfg.grid_shape\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env={"JAX_PLATFORMS": "cpu", "PATH": ""},
    )
    assert r.returncode == 0, r.stderr
