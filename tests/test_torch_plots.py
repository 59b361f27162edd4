"""The trainer's training-stat plots (``render.py::plot_training_stats``
on ``utils/pdfplot.py``), on the CPU:

* the committed JAX fine NDC run's ``logs.csv`` plotted as the JAX
  trainer plots it gives files of that run's names;
* a tiny run that validates three times writes the five ``epoch_*.pdf``
  files the JAX trainer writes after each validation (the names of
  ``demo/mlogs/mscene/*/``);
* every file parses (header, cross-reference offsets, trailer, content
  length; ``pdfplot.read_plot``), and its polylines, mapped back to data
  through the axes' tick marks and labels, give the CSV's columns within
  the plot's resolution (coordinates are written to 0.01 pt);
* a plot that fails does not stop the validation, as in JAX."""

import csv
import glob
import os
import shutil

import pytest

from adanerf_tpu_torch import train
from adanerf_tpu_torch.render import plot_training_stats
from adanerf_tpu_torch.utils.pdfplot import COLOURS, read_plot

from scene_utils import dense_config_args, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NDC_RUN = glob.glob(os.path.join(
    glob.escape(os.path.join(ROOT, "demo", "ndclogs", "llff_scene")), "*LSfCDA_(0.15)*"))[0]
PDFS = ["epoch_loss.pdf", "epoch_train_loss.pdf", "epoch_accuracy.pdf",
        "epoch_loss_train_loss_accuracy.pdf", "epoch_loss_train_loss.pdf"]
SERIES = {"epoch_loss.pdf": ["loss"], "epoch_train_loss.pdf": ["train_loss"],
          "epoch_accuracy.pdf": ["accuracy"],
          "epoch_loss_train_loss_accuracy.pdf": ["loss", "train_loss", "accuracy"],
          "epoch_loss_train_loss.pdf": ["loss", "train_loss"]}
RESOLUTION_PT = 0.05  # 0.01 pt roundings of the points and of the ticks fitted


def _axis_map(ticks):
    """Page coordinate -> data through the first and last tick; every tick
    must lie on that line."""
    (p0, v0), (p1, v1) = ticks[0], ticks[-1]
    scale = (v1 - v0) / (p1 - p0)
    for p, v in ticks:
        assert abs(v0 + (p - p0) * scale - v) <= RESOLUTION_PT * abs(scale)
    return (lambda p: v0 + (p - p0) * scale), abs(scale) * RESOLUTION_PT


def check_plot(path, rows, x_column, columns):
    """Parse ``path`` and hold its polylines to the CSV ``rows``."""
    items = read_plot(path)
    assert items[0][0] == "rect"  # the axes frame
    xt, yt = [], []
    for a, b in zip(items, items[1:]):
        if a[0] == "path" and b[0] == "text" and a[1] == (0.0, 0.0, 0.0) and len(a[2]) == 2:
            (x0, y0), (x1, y1) = a[2]
            (xt if x0 == x1 else yt).append((x0 if x0 == x1 else y0, float(b[3])))
    assert len(xt) >= 2 and len(yt) >= 2
    to_x, tol_x = _axis_map(xt)
    to_y, tol_y = _axis_map(yt)
    colours = [tuple(round(int(c[k:k + 2], 16) / 255, 4) for k in (0, 2, 4)) for c in COLOURS]
    lines = [it for it in items if it[0] == "path" and it[1] in colours]
    texts = [it[3] for it in items if it[0] == "text"]
    assert x_column in texts and all(c in texts for c in columns)
    for i, col in enumerate(columns):  # each series' line, then its legend sample
        assert lines[i][1] == colours[i]
        pts = lines[i][2]
        assert len(pts) == len(rows)
        for (px, py), row in zip(pts, rows):
            assert abs(to_x(px) - float(row[x_column])) <= tol_x
            assert abs(to_y(py) - float(row[col])) <= tol_y
    return items


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_jax_runs_logs_plot_under_the_jax_runs_names(tmp_path):
    shutil.copy(os.path.join(NDC_RUN, "logs.csv"), tmp_path / "logs.csv")
    for y in train.STAT_PLOTS:
        plot_training_stats(str(tmp_path), "logs.csv", "epoch", y)
    written = sorted(f for f in os.listdir(tmp_path) if f.endswith(".pdf"))
    assert written == sorted(f for f in os.listdir(NDC_RUN) if f.endswith(".pdf"))
    assert written == sorted(PDFS)
    rows = _rows(tmp_path / "logs.csv")
    assert len(rows) == 4
    for name in PDFS:
        check_plot(str(tmp_path / name), rows, "epoch", SERIES[name])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    scene = make_scene(str(tmp_path_factory.mktemp("scene_plots")))
    log = str(tmp_path_factory.mktemp("logs_plots"))
    argv = dense_config_args(scene, log, samples=32, epochs=7, threshold=0.2) + [
        "--device", "cpu", "--randomSeed", "0", "--epochsValidate", "2",
        "--epochsRender", "1000", "--epochsCheckpoint", "1000", "--no-performEvaluation"]
    return train.main(argv)


def test_a_validating_run_writes_the_five_plots(run):
    d = run["state"].logDir
    assert sorted(f for f in os.listdir(d) if f.endswith(".pdf")) == sorted(PDFS)
    mscene_runs = glob.glob(os.path.join(glob.escape(os.path.join(ROOT, "demo", "mlogs",
                                                                  "mscene")), "*", ""))
    assert mscene_runs and all(sorted(f for f in os.listdir(r) if f.endswith(".pdf"))
                               == sorted(PDFS) for r in mscene_runs)
    rows = _rows(os.path.join(d, "logs.csv"))
    assert [r["epoch"] for r in rows] == ["2", "4", "6"]


@pytest.mark.parametrize("name", PDFS)
def test_each_plot_parses_and_maps_back_to_the_csv(run, name):
    d = run["state"].logDir
    check_plot(os.path.join(d, name), _rows(os.path.join(d, "logs.csv")), "epoch",
               SERIES[name])


def test_a_failing_plot_does_not_stop_the_validation(run, monkeypatch):
    ts = run["state"]

    def fail(*_args):
        raise OSError("disk full")
    monkeypatch.setattr(train, "plot_training_stats", fail)
    loss, images = train.validate_batch(ts, 8, 0.5)
    assert loss > 0 and len(images) == len(ts.valid_dataset)
    assert _rows(os.path.join(ts.logDir, "logs.csv"))[-1]["epoch"] == "8"


@pytest.mark.parametrize("bad", ["header", "xref", "length"])
def test_a_damaged_file_does_not_parse(tmp_path, bad):
    shutil.copy(os.path.join(NDC_RUN, "logs.csv"), tmp_path / "logs.csv")
    plot_training_stats(str(tmp_path), "logs.csv", "epoch", "loss")
    path = tmp_path / "epoch_loss.pdf"
    data = path.read_bytes()
    if bad == "header":
        data = b"%PDX" + data[4:]
    elif bad == "xref":
        data = data.replace(b"0000000015 00000 n", b"0000000016 00000 n")
    else:
        data = data.replace(b"<< /Length ", b"<< /Length 1")
    path.write_bytes(data)
    with pytest.raises(ValueError):
        read_plot(str(path))
