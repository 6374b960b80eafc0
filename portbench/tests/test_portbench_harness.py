"""The harness is driven by data: a new cell, mix and metric are found by
name with no existing file edited; the result is printed only on a card;
and nothing a run loads is JAX or the JAX package."""
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

from portbench import harness

ROOT = Path(harness.ROOT)


def test_metrics_of_each_cell_follow_benchmark_json():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.metrics_of(bench, w["name"], True)
        assert layer and all(m["moves"] in e2e for m in layer)
        for m in harness.metrics_of(bench, w["name"], False) + layer:
            assert callable(harness.reader(m["name"]))
        assert (ROOT / "portbench" / "workloads"
                / f"{w['name']}.json").is_file()


def test_new_cell_mix_and_metric_need_only_new_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"
    (pb / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"loop": "closed", "clients": 3, "block": 8,
         "prompt": {"dist": "uniform", "lo": 4, "hi": 6},
         "output": {"dist": "uniform", "lo": 2, "hi": 3}}))
    (pb / "workloads" / "qwen2.5-3b.tiny.json").write_text(json.dumps(
        {"driver": "serve", "engine": {"max_len": 16, "chunk_tokens": 8},
         "warmup_steps": 1, "correct": {"requests": 1,
                                           "max_logit_gap": 0.1}}))
    (pb / "metrics" / "tiny.count.py").write_text(textwrap.dedent('''
        def read(run):
            return 42.0
    '''))
    bench["workloads"].append({"name": "qwen2.5-3b.tiny",
                               "config": "qwen2.5-3b", "traffic": "tiny_mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "tiny.count", "unit": "count",
                               "better": "lower", "source": "program_counter",
                               "layer": "a test", "moves": "setup_s",
                               "workloads": ["qwen2.5-3b.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = textwrap.dedent('''
        import sys
        sys.path.insert(0, sys.argv[1])
        from portbench import harness
        from portbench.traffic import generator
        bench = harness.benchmark()
        e = harness.cell(bench, "qwen2.5-3b.tiny")
        print(generator.load(e["traffic"])["clients"])
        print(harness.load_json(harness.HERE / "workloads"
                                / "qwen2.5-3b.tiny.json")["driver"])
        names = [m["name"] for m in harness.metrics_of(
            bench, "qwen2.5-3b.tiny", True)]
        print(names)
        print(harness.reader("tiny.count")(None))
    ''')
    out = subprocess.run([sys.executable, "-c", probe, str(tmp_path)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split("\n")
    assert out[0] == "3" and out[1] == "serve"
    assert "tiny.count" in out[2] and out[3] == "42.0"
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "reproducible", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.kernels", object())
    assert harness.forbidden_modules() == ["repro"]
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax", "repro"]


def test_a_run_loads_no_jax_and_no_repro():
    probe = textwrap.dedent('''
        import sys
        sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
        from portbench import control, harness, serve, tracing  # noqa
        from portbench.tests import small
        small.run("qwen2.5-3b.long_decode", seconds=0.5, trace=True)
        print(sorted({m.split(".")[0] for m in sys.modules}
                     & {"jax", "jaxlib", "flax", "repro"}))
        print(harness.forbidden_modules())
    ''')
    out = subprocess.run([sys.executable, "-c", probe, str(ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "[]"]


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "qwen2.5-3b.long_decode", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
