"""The port stands alone: no JAX, nothing of the JAX package; CUDA by default."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import kinematic_icp_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "kinematic_icp_tpu")
             or m.startswith(("jax.", "jaxlib.", "kinematic_icp_tpu.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for name in ("offline", "convert", "ops.gn", "ops.cuda_build",
                 "models.pipeline", "utils.synthetic", "utils.evaluation",
                 "server", "online", "utils.packing", "utils.checkpoint",
                 "utils.io.messages", "parallel", "parallel.batched",
                 "run_odometry", "evaluate", "baseline_native",
                 "oracle.reference", "utils.io.lz4f", "utils.io.mcap",
                 "utils.io.sqlite_bag", "utils.io.bag", "utils.io.native",
                 "utils.progress", "utils.viewer", "utils.visualization",
                 "utils.profiling", "parallel.mesh", "parallel.sharded",
                 "parallel.peer", "utils.cuda_graph"):
        assert f"kinematic_icp_tpu_torch.{name}" in res["modules"]


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/profile_torch_main_path.py",
                                    "tools/gn_kernel_pace.py",
                                    "tools/gn_kernel_parity.py",
                                    "tools/sharded_scaling.py",
                                    "tools/loop_batch_invariance.py",
                                    "examples/torch_synthetic_drive.py",
                                    "examples/torch_streaming_server.py"])
def test_card_scripts_import_no_jax(script):
    """The card's scripts run where JAX is not installed: read their import
    statements (at any depth, without running them)."""
    with open(os.path.join(REPO, script)) as fh:
        tree = ast.parse(fh.read(), filename=script)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "kinematic_icp_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "kinematic_icp_tpu"}, roots


#: JAX modules whose port counterpart has another name, by design
RENAMED = {"ops/pallas_gn.py": "ops/gn.py",
           "utils/compilation_cache.py": "utils/cuda_graph.py"}
#: the only public JAX names the port lacks, each with ROADMAP.md A's reason
BY_DESIGN = {
    ("ops/hashmap.py", "nearest_neighbor_native"):
        "nearest_neighbor at V = 27 is bit-equal to it",
    ("ops/registration.py", "pallas_gn_vmem_bytes"):
        "sizes the Pallas kernel for TPU VMEM; the CUDA kernel takes "
        "every K <= 32, as nn_from_candidates does",
    ("ops/registration.py", "pallas_gn_fits"):
        "the same TPU VMEM sizing",
    ("utils/compilation_cache.py", "enable_compilation_cache"):
        "JAX's persistent compile cache; a CUDA graph cannot outlive its "
        "process, and ops/cuda_build caches the kernel builds",
    ("utils/profiling.py", "StageTimer"):
        "wall timers that sync the device; the port's spans and counters "
        "(profiling.span, count) record at the syncs the program makes",
    ("utils/profiling.py", "sync"):
        "StageTimer's device wait, gone with it",
}


def _public_names(path):
    """A module's public names, read with ``ast`` (nothing is imported):
    its top-level functions, classes and assignments not starting with an
    underscore, and its ``__all__``."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        names.update(ast.literal_eval(node.value))
    return {n for n in names if not n.startswith("_")}


def test_port_has_every_public_name_of_the_jax_package():
    """The port is complete: every module of the JAX package has a
    counterpart (under RENAMED's names) holding each of its public names,
    but for the BY_DESIGN omissions -- which must still be missing, and
    still exist in JAX, so the list cannot go stale."""
    jax_root = os.path.join(REPO, "kinematic_icp_tpu")
    port_root = os.path.join(REPO, "kinematic_icp_tpu_torch")
    missing, modules = set(), 0
    for dirpath, _, files in os.walk(jax_root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), jax_root)
            rel = rel.replace(os.sep, "/")
            port = os.path.join(port_root, RENAMED.get(rel, rel))
            assert os.path.exists(port), f"no counterpart of {rel}"
            modules += 1
            missing |= {(rel, n) for n in _public_names(
                os.path.join(jax_root, rel)) - _public_names(port)}
    assert modules >= 40
    assert missing == set(BY_DESIGN), sorted(missing ^ set(BY_DESIGN))


@pytest.mark.parametrize("entry", ["run_offline", "init_state", "make_step",
                                   "make_sequence_runner",
                                   "make_batched_sequence_runner",
                                   "init_batched_state",
                                   "BatchedOdometryRunner",
                                   "LidarOdometryServer",
                                   "OnlineOdometryNode", "load_state",
                                   "run_odometry", "make_mesh"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch import offline, run_odometry
    from kinematic_icp_tpu_torch.models import pipeline
    from kinematic_icp_tpu_torch.online import OnlineOdometryNode
    from kinematic_icp_tpu_torch.parallel import (BatchedOdometryRunner,
                                                  make_mesh)
    from kinematic_icp_tpu_torch.server import LidarOdometryServer
    from kinematic_icp_tpu_torch.utils import checkpoint

    cfg = Config(max_points=64, max_downsampled=64, max_source=32,
                 map_capacity=256)
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, pipeline.init_state(cfg, device="cpu"))
    call = {
        "run_offline": lambda: offline.run_offline(
            [np.zeros((8, 3), np.float32)], [np.eye(4)], cfg),
        "init_state": lambda: pipeline.init_state(cfg),
        "make_step": lambda: pipeline.make_step(cfg),
        "make_sequence_runner": lambda: offline.make_sequence_runner(cfg),
        "make_batched_sequence_runner":
            lambda: offline.make_batched_sequence_runner(cfg),
        "init_batched_state": lambda: offline.init_batched_state(cfg, 2),
        "BatchedOdometryRunner": lambda: BatchedOdometryRunner(cfg, 2),
        "LidarOdometryServer": lambda: LidarOdometryServer(cfg),
        "OnlineOdometryNode": lambda: OnlineOdometryNode(cfg),
        "load_state": lambda: checkpoint.load_state(path),
        # no --device: the CLI's default is the card
        "run_odometry": lambda: run_odometry.main(
            [str(tmp_path / "drive.mcap"), "--no-progress"]),
        # before any process group is needed
        "make_mesh": lambda: make_mesh(1, 1),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_native_build_writes_only_into_the_package(tmp_path):
    """The port builds ``native/``'s sources into its own ``_build/`` and
    writes nothing under ``native/`` (where a tracked binary lives): the
    build runs in a copy of the package and the sources."""
    import shutil

    shutil.copytree(os.path.join(REPO, "kinematic_icp_tpu_torch"),
                    tmp_path / "kinematic_icp_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (tmp_path / "native").mkdir()
    for name in ("kicp_io.cpp", "kicp_baseline.cpp", "Makefile"):
        shutil.copy(os.path.join(REPO, "native", name), tmp_path / "native")

    def snapshot():
        return {p.name: p.read_bytes() for p in (tmp_path / "native").iterdir()}

    before = snapshot()
    probe = ("import json; from kinematic_icp_tpu_torch.utils.io import "
             "native; print(json.dumps({k: v['path'] for k, v in "
             "native.build('kicp_io', 'kicp_baseline').items()}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    built = json.loads(out.stdout.strip().splitlines()[-1])
    assert snapshot() == before
    for path in built.values():
        assert os.path.dirname(path) == str(
            tmp_path / "kinematic_icp_tpu_torch" / "_build")
        assert os.path.getsize(path) > 0
