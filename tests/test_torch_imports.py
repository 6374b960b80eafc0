"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package, and the
launcher's command line is checked without building a model."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "repro"
            or name.startswith("repro.") or name.startswith("jaxlib"))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "sys.path.insert(0, sys.argv[1]); import chip_smoke\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def test_launcher_no_reduced_picks_published_config():
    from repro_torch.launch import serve
    args = serve.parse_args(["--no-reduced"])
    cfg = serve.arch_config(args)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab, cfg.param_dtype) == \
        (22, 2048, 32, 4, 5632, 32000, "bfloat16")
    assert args.device == "cuda"
    assert serve.arch_config(serve.parse_args([])).n_layers == 2


@pytest.mark.parametrize("arch,family", [("deepseek-moe-16b", "moe"),
                                         ("llama4-scout-17b-a16e", "moe")])
def test_launcher_serves_the_moe_family(arch, family):
    from repro_torch.launch import serve
    cfg = serve.arch_config(serve.parse_args(["--arch", arch,
                                              "--no-reduced"]))
    assert (cfg.family, cfg.param_dtype) == (family, "bfloat16")
    assert cfg.moe is not None and cfg.input_mode == "tokens"


@pytest.mark.parametrize("arch,match", [
    ("qwen2-vl-7b", "stub frontend"), ("musicgen-large", "stub frontend"),
    ("rwkv6-3b", "engine serves KV-cache families"),
    ("zamba2-7b", "engine serves KV-cache families")])
def test_launcher_refuses_what_the_engine_cannot_serve(arch, match):
    """Embedding-input stubs, as the JAX launcher refuses them, and the
    families without a KV cache, as the engine refuses them (its
    ValueError: "engine currently serves KV-cache families"); before any
    parameter is drawn."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match=match):
        serve.arch_config(serve.parse_args(["--arch", arch]))


@pytest.mark.parametrize("argv,key,value", [
    (["--arrival-rate", "0.5"], "arrival_rate", 0.5),
    (["--trace", "t.jsonl"], "trace", "t.jsonl"),
    (["--arrival-rate", "1", "--chaos-seed", "3"], "chaos_seed", 3),
    (["--slo", "10"], "slo", 10.0),
    (["--num-kv-splits", "4"], "num_kv_splits", 4),
    (["--dtype", "float32"], "dtype", "float32"),
    (["--kv-shards", "2"], "kv_shards", 2),
])
def test_launcher_accepts_the_ported_flags(argv, key, value):
    from repro_torch.launch import serve
    args = serve.parse_args(argv)
    assert getattr(args, key) == value
    assert serve.open_loop(args) == ("--trace" in argv
                                     or "--arrival-rate" in argv)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_launcher_kv_shards_beyond_the_visible_devices_exits(device):
    """``main`` builds the kv mesh over the visible devices of
    ``--device``'s type (the CPU counts as one) before any parameter is
    drawn; more shards than those exit with JAX's device-count message."""
    import torch

    from repro_torch.launch import serve
    n = 1 if device == "cpu" else torch.cuda.device_count()
    with pytest.raises(SystemExit, match=f"--kv-shards: kv mesh needs 8 "
                                         f"devices but only {n} are visible"):
        serve.main(["--kv-shards", "8", "--device", device])


@pytest.mark.parametrize("argv,match", [
    (["--num-kv-splits", "0"], "num-kv-splits must be >= 1"),
    (["--chaos-seed", "3"], "needs open-loop mode"),
    (["--trace", "t.jsonl", "--arrival-rate", "1"], "exclusive"),
])
def test_launcher_refuses_bad_flag_combinations(argv, match):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match=match):
        serve.parse_args(argv)


def test_launcher_dtype_overrides_the_published_dtype():
    from repro_torch.launch import serve
    cfg = serve.arch_config(serve.parse_args(["--no-reduced", "--dtype",
                                              "float32"]))
    assert (cfg.param_dtype, cfg.compute_dtype, cfg.d_model) == \
        ("float32", "float32", 2048)


def test_entry_points_refuse_a_missing_card():
    import torch

    from repro_torch import device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve("cuda")
