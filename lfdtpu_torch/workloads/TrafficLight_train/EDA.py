# -*- coding: utf-8 -*-
# Dataset scale-distribution statistics of the PyTorch port (reference
# `TrafficLight_train/EDA.py`, mirroring `workloads/TrafficLight_train/
# EDA.py`): histograms of the boxes' shorter, longer and sqrt(w * h) sides,
# used to pick the detection ranges of a workload config.
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch.data import Dataset  # noqa: E402


def analyze(dataset_path, bins=(0, 8, 16, 32, 64, 128, 256, 512, 10**9)):
    dataset = Dataset(load_path=dataset_path)
    print(dataset)
    hists = {"shorter": {}, "longer": {}, "sqrt": {}}
    num_bboxes = 0
    for index in dataset.get_indexes():
        sample = dataset[index]
        for bbox in sample.get("bboxes", []):
            w = int(bbox[2] + 0.5)
            h = int(bbox[3] + 0.5)
            num_bboxes += 1
            for name, v in (
                ("shorter", min(w, h)),
                ("longer", max(w, h)),
                ("sqrt", int(math.sqrt(w * h) + 0.5)),
            ):
                for lo, hi in zip(bins[:-1], bins[1:]):
                    if lo <= v < hi:
                        key = f"[{lo},{hi})"
                        hists[name][key] = hists[name].get(key, 0) + 1
                        break
    print(f"total bboxes: {num_bboxes}")
    for name, hist in hists.items():
        print(f"-- {name} side distribution:")
        for key in sorted(hist, key=lambda k: int(k[1:].split(",")[0])):
            c = hist[key]
            print(f"   {key:>16}: {c:>8} ({100.0 * c / max(num_bboxes, 1):.1f}%)")
    return hists


if __name__ == "__main__":
    analyze("./TL_pack/tl_train.pkl")
