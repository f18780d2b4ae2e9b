"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and its entry points
refuse to run on the host unless the CPU is asked for."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            mods.add(node.args[0].value)
    return mods


def test_port_imports_neither_jax_nor_the_jax_package():
    assert len(PORT_FILES) > 20
    bad = {}
    for path in PORT_FILES:
        hits = sorted(m for m in _imported_modules(path)
                      if m.split(".")[0] in FORBIDDEN)
        if hits:
            bad[str(path.relative_to(ROOT))] = hits
    assert not bad, bad


def test_scan_covers_the_analysis_and_compression_modules():
    """The twins of the reference's analysis package and of its gradient
    compression are among the scanned files, and import no JAX."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES if "repro_torch" in p.parts}
    for mod in ("analysis/__init__.py", "analysis/__main__.py",
                "analysis/lint.py", "analysis/rules.py",
                "analysis/statespace.py", "analysis/schedcheck.py",
                "analysis/sanitizer.py", "optim/compression.py"):
        assert mod in names, mod
    assert not {m for m in ("lint", "rules", "statespace", "schedcheck")
                for x in _imported_modules(
                    ROOT / "src" / "repro_torch" / "analysis" / f"{m}.py")
                if x.split(".")[0] in FORBIDDEN}


def test_import_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch\nfrom repro.models import layers\n"
                 "def g():\n    import jax.numpy as jnp\n")
    assert {m.split(".")[0] for m in _imported_modules(f)} & set(FORBIDDEN) \
        == {"repro", "jax"}


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_refuse_the_host_without_an_explicit_device():
    _no_cuda()
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from torch_port_fixtures import QWEN_TINY, port_arch
    arch = port_arch(QWEN_TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(arch, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_lm(arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(arch, {}, device="cuda")
    params = T.init_lm(arch, device="cpu")
    assert params["embed"]["embedding"].device.type == "cpu"


def test_serve_cli_refuses_the_host_without_device_flag():
    _no_cuda()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen3-8b", "--smoke"])


def test_serve_cli_refuses_the_host_for_mamba2_without_device_flag():
    _no_cuda()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "mamba2-780m", "--smoke"])


def test_serve_cli_serves_mamba2_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
                "--requests", "3", "--prompt-len", "6", "--max-new", "3",
                "--max-len", "32", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "[continuous/greedy] 3 requests, 9 tokens" in out


def test_serve_cli_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                "--requests", "3", "--prompt-len", "6", "--max-new", "3",
                "--max-len", "32", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "[continuous/greedy] 3 requests, 9 tokens" in out


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    _no_cuda()
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
    assert "FAILED" in r.stderr


def test_kernel_counters_count_only_kernel_launches():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SSD

    def counts():
        return (RN.rmsnorm.launches, FA.flash_attention.launches,
                SSD.ssd_scan.launches)
    before = counts()
    x = torch.from_numpy(np.ones((2, 8), np.float32))
    RN.rmsnorm(x, torch.ones(8))
    q = torch.zeros((1, 2, 3, 16))
    FA.flash_attention(q, q, q)
    d = torch.full((1, 2, 3), 0.1)
    SSD.ssd_scan(q, q[:, :, :1], q[:, :, :1], d, -d)
    assert counts() == before


def test_the_planner_trainer_and_checkpoint_modules_are_scanned():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for m in ("core/asa.py", "core/components.py", "core/costmodel.py",
              "core/solver.py", "core/strategy.py", "core/hardware.py",
              "core/sharding.py", "core/profiler.py", "runtime/trainer.py",
              "runtime/sharded.py", "checkpoint/store.py", "launch/mesh.py",
              "launch/train.py", "optim/quantized.py",
              "examples/quickstart.py", "data/pipeline.py"):
        assert f"src/repro_torch/{m}" in scanned, m


def test_train_cli_quickstart_and_mesh_refuse_the_host_without_device():
    _no_cuda()
    from repro_torch.examples import quickstart
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        M.make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen3-8b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])


def test_the_paper_experiment_modules_are_scanned():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for m in ("models/vision.py", "examples/paper_repro.py",
              "examples/paper_repro_asa.py", "data/pipeline.py"):
        assert f"src/repro_torch/{m}" in scanned, m


def test_paper_demo_and_vision_init_refuse_the_host_without_device():
    _no_cuda()
    from repro_torch.examples import paper_repro_asa
    from repro_torch.models import vision as V
    with pytest.raises(RuntimeError, match="CUDA"):
        paper_repro_asa.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        V.init_vit(V.ViTConfig(n_layers=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        V.init_resnet(V.ResNetConfig(stage_sizes=(1,)))


def test_the_cluster_modules_are_scanned():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for m in ("serving/detok.py", "serving/placement.py",
              "serving/cluster/__init__.py", "serving/cluster/protocol.py",
              "serving/cluster/affinity.py", "serving/cluster/router.py",
              "serving/cluster/frontend.py", "serving/cluster/worker.py",
              "serving/cluster/launcher.py", "launch/serve_cluster.py"):
        assert f"src/repro_torch/{m}" in scanned, m


def test_cluster_worker_and_launcher_refuse_the_host_without_device():
    _no_cuda()
    from repro_torch.serving.cluster import worker
    with pytest.raises(RuntimeError, match="CUDA"):
        worker.main(["--connect", "127.0.0.1:9", "--replica-id", "0",
                     "--arch", "qwen3-8b", "--smoke"])
    # the launcher's worker dies at boot, and the launcher fails loudly
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_cluster", "--arch",
         "qwen3-8b", "--smoke", "--replicas", "1", "--boot-timeout", "60"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode != 0
    assert "no CUDA device available" in r.stderr
    assert "exited before connecting" in r.stderr
    assert "serving on" not in r.stdout
