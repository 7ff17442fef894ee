"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, every module imports without a CUDA toolkit, and the entry
points refuse to run without a GPU unless the caller asks for the CPU."""
import ast
import importlib
import pkgutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
# the port, its chip smoke, and the card-only tests (which must run where
# JAX is not installed)
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_never_imports_jax_or_reference(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.core import x\n"
                     "from repro_torch.core import formats\n")
    assert [m for m in _imported_modules(probe) if _forbidden(m)] == [
        "jax.numpy", "repro.core"]


def test_every_module_imports_without_a_toolkit():
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.kernels.mixfp4_gemm" in names
    for name in names:
        importlib.import_module(name)


def _require_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")


def test_entry_points_raise_without_gpu():
    _require_no_gpu()
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeEngine

    cfg = configs.smoke_config("gemma2-2b")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 16, kv_quant="mixfp4")
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params, batch_size=1, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke"])
    ServeEngine(cfg, params, batch_size=1, max_len=16, device="cpu")


def test_launch_serve_runs_on_cpu_when_asked(capsys, tmp_path):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--device", "cpu", "--kv-quant", "mixfp4",
                "--requests", "3", "--batch", "2", "--new-tokens", "3",
                "--max-len", "32"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out
    assert "packed MixFP4 KV cache" in out
    serve.main(["--smoke", "--device", "cpu", "--kv-quant", "mixfp4",
                "--act-quant", "mixfp4", "--act-rht", "--requests", "3",
                "--batch", "2", "--new-tokens", "3", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out
    assert "qmm -> W4A4 kernels" in out
    assert "act_quant=mixfp4, act_rht=True" in out
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--act-rht"])
    serve.main(["--smoke", "--device", "cpu", "--kv-quant", "mixfp4",
                "--kv-pool", "9", "--kv-page-len", "16", "--prefill-chunk",
                "4", "--requests", "3", "--batch", "2", "--new-tokens", "3",
                "--max-len", "32"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out
    assert "chunked-prefill scheduler armed" in out
    assert "KV pool: 8 pages x 16 rows" in out
    assert "prefix hits 0 pages" not in out       # the shared page hits
    with pytest.raises(ValueError, match="kv_quant"):
        serve.main(["--smoke", "--device", "cpu", "--kv-pool", "9"])
    with pytest.raises(ValueError, match="multiple of 16"):
        serve.main(["--smoke", "--device", "cpu", "--kv-quant", "mixfp4",
                    "--kv-pool", "9", "--kv-page-len", "8"])
    with pytest.raises(ValueError, match=">= 1"):
        serve.main(["--smoke", "--device", "cpu", "--prefill-chunk", "-1"])
    # the lifecycle: a bounded queue (the third request waits for room),
    # a default deadline and a seeded slow-decode schedule
    serve.main(["--smoke", "--device", "cpu", "--kv-quant", "mixfp4",
                "--requests", "3", "--batch", "2", "--new-tokens", "3",
                "--max-len", "32", "--max-queue", "2", "--deadline-ms",
                "1e6", "--inject-faults", "0:decode=slow:5"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out
    assert "fault injection armed: seed 0, 1 rule(s)" in out
    assert ("lifecycle: {'FINISHED': 3} (queue bound 2, deadline 1000000.0 "
            "ms, ttft budget off ms)") in out
    assert "'rejected:queue_full': 1" in out
    assert "'injected_slow_ms': 20" in out
    assert "injector fired 4 event(s): {'slow': 4}" in out
    # a journaled run killed by an injected crash at its fourth step, then
    # a run that resumes the journal before serving its own requests
    jdir = str(tmp_path / "journal")
    journaled = ["--smoke", "--device", "cpu", "--kv-quant", "mixfp4",
                 "--requests", "3", "--batch", "2", "--new-tokens", "3",
                 "--max-len", "32", "--journal-dir", jdir]
    serve.main(journaled + ["--journal-sync", "always", "--inject-faults",
                            "0:process_crash=error@3"])
    out = capsys.readouterr().out
    assert (f"request journal at {jdir} (sync=always): 0 record(s) on "
            "disk, 0 torn/corrupt byte(s) truncated") in out
    assert "injected process crash after 8 tokens" in out
    serve.main(journaled + ["--recover"])
    out = capsys.readouterr().out
    assert f"request journal at {jdir} (sync=batch): 13 record(s)" in out
    assert ("journal recovery: 13 record(s) -> 3 request(s) (2 already "
            "terminal, 1 resumed, 0 finalized from history)") in out
    assert "3 requests, 10 tokens" in out
    assert "lifecycle: {'FINISHED': 4}" in out
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--recover"])
    with pytest.raises(ValueError, match="bad fault spec"):
        serve.main(["--smoke", "--device", "cpu", "--inject-faults",
                    "decode=slow"])
    with pytest.raises(ValueError, match="fault kind"):
        serve.main(["--smoke", "--device", "cpu", "--inject-faults",
                    "0:decode=bogus"])
    with pytest.raises(ValueError, match="max_queue=0 must be >= 1"):
        serve.main(["--smoke", "--device", "cpu", "--max-queue", "0"])
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--deadline-ms", "soon"])


def test_kernel_wrappers_reject_other_devices():
    from repro_torch.kernels import ops
    x = torch.zeros(4, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.quantize_rows(x, scale32=1.0)
    w = ops.pack_weight_qt(torch.from_numpy(
        np.random.RandomState(0).randn(32, 32).astype(np.float32)))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.gemm_w4a16(x, w.payload.to("meta"), w.scales.to("meta"),
                       torch.ones((), device="meta"))


def test_build_key_follows_included_headers(tmp_path, monkeypatch):
    """A cached kernel library is keyed on its source and every header the
    source includes: editing a shared header rebuilds exactly the sources
    that include it (the block-math header: every source; the GEMM tile
    header: the two GEMM sources)."""
    import shutil
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    for name, want in (("mixfp4_gemm_tile.cuh",
                        {"mixfp4_gemm_w4a16", "mixfp4_gemm_w4a4"}),
                       ("mixfp4_block_math.cuh",
                        {"mixfp4_quant", "mixfp4_gemm_w4a16",
                         "mixfp4_gemm_w4a4", "fwht_rows",
                         "mixfp4_attn_decode"})):
        before = {n: build._target(n) for n in build.SOURCES}
        header = csrc / name
        header.write_text(header.read_text() + "\n// edited\n")
        after = {n: build._target(n) for n in build.SOURCES}
        assert {n for n in build.SOURCES if before[n] != after[n]} == want
