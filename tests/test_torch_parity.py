"""Signature parity of the two packages, read with ``ast`` (nothing is
imported): every public function and every public method of a public class
in each ``mops_tpu/**.py`` has a counterpart of the same name in the same
module of ``mops_tpu_torch/``, taking every parameter name the JAX one
takes, so that a user's script that calls mops_tpu by keyword calls the
port the same way.  Names with a leading underscore are out of scope.  The
exceptions are the allow-lists below, each with its reason; an entry that
no longer matches anything fails too, so that the lists stay exact.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX, PORT = ROOT / "mops_tpu", ROOT / "mops_tpu_torch"

# Subpackages of mops_tpu that have no counterpart module.
SKIP_DIRS = {
    "pallas": "the Pallas TPU kernels; the port's are kernels/ and csrc/",
}
# Functions or methods (by their own name) with no counterpart.
SKIP_NAMES = {
    "enable_x64": "JAX's x64 switch; torch takes the dtype of each call",
    "astype": "the port moves and casts with .to(device, dtype)",
    "device_mesh": "a jax.sharding Mesh; the port takes a device list",
    "replicate": "jax.device_put over a Mesh; the port copies the tables "
                 "once to each device of the list",
    "pad_to_multiple": "pads the particle axis to the Mesh's size; the "
                       "port's slices need no padding",
    "start": "TimerManager's name-keyed start/stop: the port's recorder "
             "nests spans on a per-thread stack (span, timer)",
    "stop": "TimerManager's name-keyed start/stop (see start)",
}
# Parameters with no counterpart, anywhere or in one function.
SKIP_PARAMS = {
    "use_pallas": "the Pallas kernel switch; the port's is use_kernel",
    "dmesh": "a jax.sharding Mesh; the port takes devices=",
    ("shard_particles", "mesh"): "a jax.sharding Mesh; the port takes the "
                                 "device list",
    ("run_advection_sharded", "mpas_mesh"): "the port's alias of "
                                            "run_advection names it mesh",
    ("advection_schedule", "real"): "the JAX dtype of the stage alphas; the "
                                    "port's are Python floats",
    ("run_advection_migrating", "dmesh"): "a jax.sharding Mesh; the port "
                                          "takes devices=",
    ("record", "ms"): "TimerManager.record: the port's takes the span's "
                      "start and end on the profiler's clock",
}


def _params(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")] \
        + ["*" + x.arg for x in (a.vararg,) if x] \
        + ["**" + x.arg for x in (a.kwarg,) if x]


def public_signatures(path):
    """{name: parameter names} of a module's public functions and of its
    public classes' public methods (``Class.method``)."""
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    out = {}
    for node in ast.parse(path.read_text()).body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, defs):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            out.update({f"{node.name}.{sub.name}": _params(sub)
                        for sub in node.body if isinstance(sub, defs)
                        and not sub.name.startswith("_")})
    return out


def gaps(rel, jax=JAX, port=PORT):
    """What the port's module lacks of mops_tpu's ``rel``, after the
    allow-lists, and the allow-list entries it used."""
    want = public_signatures(jax / rel)
    port = port / rel
    have = public_signatures(port) if port.exists() else None
    missing, used = [], set()
    if have is None:
        return [f"no module mops_tpu_torch/{rel}"] if want else [], used
    for name, params in want.items():
        short = name.rsplit(".", 1)[-1]
        if short in SKIP_NAMES:
            used.add(short)
        elif name not in have:
            missing.append(f"{rel}: {name}")
        else:
            for p in params:
                key = next((k for k in ((short, p), p) if k in SKIP_PARAMS),
                           None)
                if key is not None:
                    used.add(key)
                elif p not in have[name]:
                    missing.append(f"{rel}: {name}({p}=)")
    return missing, used


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
                 if p.relative_to(JAX).parts[0] not in SKIP_DIRS)


@pytest.mark.parametrize("rel", MODULES)
def test_port_module_takes_every_public_name_and_parameter(rel):
    assert gaps(rel)[0] == []


def test_allow_lists_are_exact():
    """Every skipped directory exists in mops_tpu and not in the port, and
    every skipped name or parameter is one that some module needs."""
    for d in SKIP_DIRS:
        assert (JAX / d).is_dir() and not (PORT / d).exists()
    used = set().union(*(gaps(rel)[1] for rel in MODULES))
    assert used == set(SKIP_NAMES) | set(SKIP_PARAMS)


def test_parity_finds_what_the_port_lacks(tmp_path):
    """The check itself: a method that drops a keyword, a missing function
    and a missing module are reported; allow-listed names are not."""
    jax, port = tmp_path / "jax", tmp_path / "port"
    for d in (jax, port):
        d.mkdir()
    (jax / "api.py").write_text(
        "class App:\n"
        "    def run(self, cfg, pts, devices=None, use_pallas=True): ...\n"
        "    def _private(self, x): ...\n"
        "def astype(m, dtype): ...\n"
        "def helper(a): ...\n")
    (port / "api.py").write_text(
        "class App:\n    def run(self, cfg, pts): ...\n")
    (jax / "extra.py").write_text("def f(): ...\n")
    assert gaps("api.py", jax, port) == (
        ["api.py: App.run(devices=)", "api.py: helper"],
        {"use_pallas", "astype"})
    assert gaps("extra.py", jax, port)[0] == ["no module "
                                              "mops_tpu_torch/extra.py"]
