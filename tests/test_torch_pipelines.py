"""The port's demo pipelines (``python -m adanerf_tpu_torch.pipelines``)
against the JAX package's scripts, on the CPU: each recipe's trainer
arguments equal the bash arrays of its script (``tools/run_*_pipeline.sh``,
``run_r5_queue.sh``'s leg A and B, ``run_r5_fine.sh``), split as the shell
splits them, and its steps (the supervised legs with their logs and stall
limits, the export, the run folder copied to the export folder,
``evaluate``, ``eval_megakernel``, the bench) come in the script's order
with the script's arguments; ``--log-root`` and ``--export-root`` move
every path the pipeline writes out of ``demo/``; ``run`` stops at a failed
leg. The legs themselves run on the card (``chip_smoke.py`` phase 22)."""

import os
import re
import shlex

import pytest

from adanerf_tpu_torch import pipelines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    """(bash arrays, the script's commands in order) of tools/<name>."""
    with open(os.path.join(ROOT, "tools", name)) as f:
        text = f.read()
    arrays = {m.group(1): shlex.split(m.group(2), comments=True)
              for m in re.finditer(r"^(\w+)=\((.*?)\)$", text, re.S | re.M)}
    text = re.sub(r"^\w+=\(.*?\)$", "", text, flags=re.S | re.M).replace("\\\n", " ")
    steps = []
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if not words:
            continue
        use = [arrays[m] for m in re.findall(r'"\$\{(\w+)\[@\]\}"', line)]
        tee = words[words.index("tee") + 1] if "tee" in words else ""
        if "tools/supervise_train.py" in words:
            steps.append(("train", use[0], words[words.index("--log") + 1],
                          float(words[words.index("--stall-min") + 1])))
        elif words[:2] == ["python", "export.py"]:
            steps.append(("export", use[0]))
        elif "$(ls -d" in line:  # FINE_DIR=$(ls -d <runs>/*'(thr)'*/ | head -1)
            steps.append(("runs", re.search(r"ls -d (\S+?)/ \|", line).group(1)
                          .replace("'", "")))
        elif words[:2] == ["cp", "-r"]:
            steps.append(("copy", words[3]))
        elif words[:2] == ["python", "evaluate.py"]:
            steps.append(("evaluate", words[2:words.index("2>&1")], tee))
        elif words[:2] == ["python", "tools/eval_megakernel.py"]:
            steps.append(("eval_megakernel", words[2:words.index("2>&1")], tee))
        elif words[:2] == ["python", "bench.py"]:
            steps.append(("bench", words[2:words.index("2>&1")], tee))
    return arrays, steps


def _as_script_steps(steps):
    """A recipe's steps in the form ``_script`` parses a script into."""
    out = []
    for s in steps:
        if s.kind == "train":
            out.append(("train", s.argv, s.log, s.stall_min))
        elif s.kind == "export":
            out.append(("export", s.argv))
        elif s.kind == "copy":
            out += [("runs", s.argv[0]), ("copy", s.argv[1])]
        else:
            out.append((s.kind, s.argv, s.log))
    return out


def _expected(recipe):
    if recipe == "mscene_thr001":
        return _script("run_r5_queue.sh")[1][:5]  # leg A
    if recipe == "mscene300":  # leg B, then the corrected leg C
        return [_script("run_r5_queue.sh")[1][5]] + _script("run_r5_fine.sh")[1]
    return _script(f"run_{recipe}_pipeline.sh")[1]


@pytest.mark.parametrize("recipe", sorted(pipelines.RECIPES))
def test_recipe_runs_its_scripts_steps_in_order(recipe):
    got = _as_script_steps(pipelines.recipe(recipe))
    want = _expected(recipe)
    assert [s[0] for s in got] == [s[0] for s in want]
    assert got == want


@pytest.mark.parametrize("script,arrays", [
    ("run_mscene_pipeline.sh", {"DENSE_ARGS": "MSCENE_DENSE_ARGS",
                                "FINE_ARGS": "MSCENE_FINE_ARGS"}),
    ("run_tscene_pipeline.sh", {"DENSE_ARGS": "TSCENE_DENSE_ARGS",
                                "FINE_ARGS": "TSCENE_FINE_ARGS"}),
    ("run_ndc_pipeline.sh", {"DENSE_ARGS": "NDC_DENSE_ARGS", "FINE_ARGS": "NDC_FINE_ARGS"}),
    ("run_r5_queue.sh", {"F001_ARGS": "F001_ARGS", "D300_ARGS": "D300_ARGS"}),
    ("run_r5_fine.sh", {"F300_ARGS": "F300_ARGS"})])
def test_arg_lists_are_the_scripts_arrays_verbatim(script, arrays):
    parsed = _script(script)[0]
    for bash, ours in arrays.items():
        assert shlex.split(getattr(pipelines, ours)) == parsed[bash]


def test_the_300k_fine_leg_is_the_corrected_one():
    """run_r5_fine.sh's leg: the ini's loss blending (no override, so the
    teacher's name matches) and 75,001 epochs, where run_r5_queue.sh's leg
    C overrode the blending and ran 40,001."""
    fine = pipelines.recipe("mscene300")[1].argv
    queue_c = _script("run_r5_queue.sh")[0]["F300_ARGS"]
    assert "--lossBlendingStart" not in fine and "--lossBlendingStart" in queue_c
    assert fine[fine.index("-e") + 1] == "75001"


def test_the_roots_move_every_written_path_out_of_demo(tmp_path):
    logs, exports = str(tmp_path / "logs"), str(tmp_path / "exports")
    for name in pipelines.RECIPES:
        steps = pipelines.recipe(name, log_root=logs, export_root=exports, device="cpu",
                                 leg_args={"fine": ["-e", "5"]})
        for s in steps:
            if s.kind == "train":
                assert s.log.startswith(logs) and s.argv[-2:] == ["--device", "cpu"]
                for flag in ("-log", "--preTrained"):
                    assert all(s.argv[i + 1].startswith(logs)
                               for i, a in enumerate(s.argv) if a == flag)
                assert s.command()[-len(s.argv):] == s.argv
                assert "-u" in s.command() and "--stall-min" in s.command()
            if s.kind == "copy":
                assert s.argv[0].startswith(logs) and s.argv[1].startswith(exports)
            if s.kind in ("evaluate", "eval_megakernel", "bench"):
                assert s.log.startswith(logs)
            if s.kind == "eval_megakernel":
                assert s.argv[0].startswith(exports)
        fine = [s for s in steps if s.kind == "train"][-1]
        assert fine.argv[-4:] == ["-e", "5", "--device", "cpu"]
        assert [s for s in steps if s.kind == "export"][0].argv == fine.argv


def test_run_stops_at_a_failed_leg(monkeypatch, capsys):
    ran = []

    def fake(step):
        ran.append(step.kind if step.kind != "train" else step.leg)
        return 1 if step.leg == "fine" and step.kind == "train" else 0
    monkeypatch.setattr(pipelines, "run_step", fake)
    monkeypatch.setattr(pipelines.os, "chdir", lambda d: None)
    assert pipelines.run("tscene") == 1
    assert ran == ["dense", "fine"]
    ran.clear()
    monkeypatch.setattr(pipelines, "run_step", lambda s: ran.append(s.kind) or 0)
    assert pipelines.run("tscene") == 0
    assert ran == ["train", "train", "export", "copy", "evaluate", "eval_megakernel", "bench"]
    assert capsys.readouterr().out.splitlines()[-1] == "PIPELINE DONE"


def test_the_bench_step_is_skipped_by_name(capsys):
    bench = pipelines.recipe("ndc")[-1]
    assert pipelines.run_step(bench) == 0
    out = capsys.readouterr().out
    assert ("skipping tools/run_ndc_pipeline.sh's bench.py --export-dir "
            "demo/trained_ndc_export") in out
    assert "ROADMAP Queue 1, item 2" in out


def test_the_cli_parses_leg_args(monkeypatch):
    seen = {}
    monkeypatch.setattr(pipelines, "run", lambda name, **kw: seen.update(name=name, **kw) or 0)
    assert pipelines.main(["tscene", "--log-root", "/x", "--leg-args", "dense", "-e 601 -Eckpt 200",
                           "--leg-args", "fine", "-e 301", "--device", "cpu"]) == 0
    assert seen == {"name": "tscene", "log_root": "/x", "export_root": "demo", "device": "cpu",
                    "leg_args": {"dense": ["-e", "601", "-Eckpt", "200"], "fine": ["-e", "301"]}}
    with pytest.raises(SystemExit):
        pipelines.main(["mscene_thr001", "--leg-args", "dense", "-e 5"])
