"""Aggregate evaluated experiments into comparison.csv or comparison.xml:

  python -m adanerf_tpu_torch.comparison -d <dataset log dir> [-f csv|xml]

A copy of the JAX package's root ``comparison.py`` (standard library only),
so that the port reads its own reports: it walks the experiment
directories under ``-d``, parses ``network_description.txt``,
``complexity.txt``, ``opt.txt`` and the image-quality CSVs, and reads the
adaptive threshold back out of each directory's name.
"""

import argparse
import os
import re
import statistics
import sys

METRICS = ["samples", "mse", "psnr", "ssim", "flip", "sparsity"]
CSV_METRIC_ORDER = ["mse", "psnr", "ssim", "flip", "samples", "sparsity"]


class ExperimentResults:
    def __init__(self, path):
        self.params = -1
        self.flops = 0
        self.flops_per_pixel = 0
        self.epoch = -1
        self.completed = False
        _, self.experiment_name = os.path.split(path.rstrip(os.path.sep))
        self.ims = None
        self.vds = None
        self.thresholds = ""

        m = re.search(r"LSfCDA_\((\d+\.\d+)\)", self.experiment_name)
        if m is not None:
            self.thresholds = m.group(1)

        params_ok = self._read_params(os.path.join(path, "network_description.txt"))
        complexity_ok = self._read_complexity(os.path.join(path, "complexity.txt"))
        img_path = os.path.join(path, "image_quality_images.csv")
        vid_path = os.path.join(path, "image_quality_video.csv")
        img_ok = os.path.exists(img_path)
        if img_ok:
            self.ims = read_quality_info(img_path)
        if os.path.exists(vid_path):
            self.vds = read_quality_info(vid_path)
        self._read_opt_epoch(os.path.join(path, "opt.txt"))
        self.completed = params_ok and complexity_ok and img_ok

    def _read_params(self, path):
        if not os.path.exists(path):
            return False
        with open(path) as f:
            m = re.search(r'\d+', f.readline())
            if m:
                self.params = m.group(0)
        return True

    def _read_complexity(self, path):
        if not os.path.exists(path):
            return False
        line = ""
        with open(path) as f:
            for line in f:
                pass
        m = re.findall(r'\d+\.?\d*(?:e[+-]?\d+)?', line)
        if ':' in line and len(m) >= 2:
            gmacs, gmacs_pp = float(m[0]), float(m[1])
            self.flops = gmacs * 2
            self.flops_per_pixel = gmacs_pp * 2
        return True

    def _read_opt_epoch(self, path):
        if not os.path.exists(path):
            return
        with open(path) as f:
            m = re.search(r'\d+$', f.readline())
            if m:
                self.epoch = m.group(0)


def read_quality_info(path):
    metrics = {m: [] for m in CSV_METRIC_ORDER}
    with open(path) as f:
        for idx, line in enumerate(f.read().replace('\r', '\n').splitlines()):
            if idx == 0 or not line.strip():
                continue
            vals = re.findall(r'-?\d+\.?\d*(?:e[+-]?\d+)?', line)
            for name, v in zip(CSV_METRIC_ORDER, vals):
                metrics[name].append(float(v))
    stats = {}
    for name in CSV_METRIC_ORDER:
        vals = metrics[name]
        stats[name] = [statistics.mean(vals), min(vals), max(vals)] \
            if vals else [-1, -1, -1]
    return stats


def csv_lines(results):
    yield ("Experiment_Name,Num_Parameters,Threshold,FLOPS,FLOPS_Per_Pixel,"
           "Optimal_Epoch,Samples_Average,MSE_Average,PSNR_Average,"
           "SSIM_Average,FLIP_Average,Sparsity_Average,Samples_Average_Video,"
           "MSE_Average_Video,PSNR_Average_Video,SSIM_Average_Video,"
           "FLIP_Average_Video,Sparsity_average_Video\r")
    for r in results:
        s = (f"{r.experiment_name},{r.params},{r.thresholds},{r.flops},"
             f"{r.flops_per_pixel},{r.epoch}")
        for m in METRICS:
            s += f",{r.ims[m][0]}"
        for m in METRICS:
            s += f",{r.vds[m][0]}" if r.vds is not None else ",-1"
        yield s + "\r"


def xml_lines(results):
    yield '<?xml version="1.0" encoding="UTF-8"?>\r<experiments>\r'
    for r in results:
        yield "\t<experiment>\r"
        s = (f"\t\t<name>{r.experiment_name}</name>\r"
             f"\t\t<parameters>{r.params}</parameters>\r"
             f"\t\t<threshold>{r.thresholds}</threshold>\r"
             f"\t\t<flops>{r.flops}</flops>\r"
             f"\t\t<flops-per-pixel>{r.flops_per_pixel}</flops-per-pixel>\r"
             f"\t\t<optimal-epoch>{r.epoch}</optimal-epoch>\r")
        for m in METRICS:
            s += f"\t\t<{m}-average>{r.ims[m][0]}</{m}-average>\r"
        for m in METRICS:
            v = r.vds[m][0] if r.vds is not None else -1
            s += f"\t\t<{m}-average-video>{v}</{m}-average-video>\r"
        yield s
        yield "\t</experiment>\r"
    yield "</experiments>\r"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('-d', '--directory', required=True, type=str)
    p.add_argument('-f', '--format', default='csv', choices=["csv", "xml"])
    cl = p.parse_args(argv)

    paths = [os.path.join(cl.directory, s)
             for s in sorted(os.listdir(cl.directory))
             if os.path.isdir(os.path.join(cl.directory, s))]
    results = [r for r in (ExperimentResults(p_) for p_ in paths) if r.completed]

    gen = csv_lines if cl.format == 'csv' else xml_lines
    with open(os.path.join(cl.directory, f"comparison.{cl.format}"), "w") as f:
        for line in gen(results):
            f.write(line)
    print(f"wrote comparison.{cl.format} ({len(results)} experiments)")
    return results


if __name__ == "__main__":
    main()
