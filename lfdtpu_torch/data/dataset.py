# Packed dataset, a copy of `lfdtpu/data/dataset.py` (reference
# `lfd/data_pipeline/dataset/dataset.py`).
#
# Same on-disk pickle schema, `[meta_info, {index: Sample}]`. A pickled
# Sample names its class's module, so a pack from lfdtpu (or the reference)
# names `lfdtpu.data.sample`; the loader maps every `*.sample.Sample` onto
# this package's Sample, and so never imports lfdtpu (and jax) to read one.
# A pack written here names `lfdtpu_torch.data.sample`, which lfdtpu's plain
# pickle.load imports.

from __future__ import annotations

import os
import pickle

from .sample import Sample


class _PackUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "Sample" and module.rsplit(".", 1)[-1] == "sample":
            return Sample
        return super().find_class(module, name)


class Dataset:
    def __init__(self, parser=None, save_path=None, load_path=None, verbose=True):
        if load_path is not None:
            assert os.path.exists(load_path), f"[{load_path}] path does not exist!"
            self._load_path = load_path
            with open(load_path, "rb") as f:
                self._meta_info, self._dataset = _PackUnpickler(f).load()
        else:
            assert parser is not None
            assert save_path is not None, "When parser is provided, the save_path must be set!"
            self._parser = parser
            self._save_path = save_path
            self._build_dataset(verbose)

    def _build_dataset(self, verbose):
        parent = os.path.dirname(self._save_path)
        if parent and not os.path.exists(parent):
            os.makedirs(parent)
        self._dataset = {}
        self._meta_info = self._parser.get_meta_info()
        for index, sample in enumerate(self._parser.generate_sample()):
            self._dataset[index] = sample
            if verbose and index % 500 == 0:
                print(f"Sample [{index}] is processed.")
        with open(self._save_path, "wb") as f:
            pickle.dump([self._meta_info, self._dataset], f, pickle.HIGHEST_PROTOCOL)

    def __getitem__(self, index):
        return self._dataset[index]

    def __len__(self):
        return len(self._dataset)

    def get_indexes(self):
        return list(self._dataset.keys())

    @property
    def meta_info(self):
        return self._meta_info

    def __str__(self):
        return self.get_dataset_statistics()

    def get_dataset_statistics(self):
        """Per-class bbox statistics printer (`dataset.py:86-107`)."""
        num_with_bboxes = 0
        per_label = {}
        for sample in self._dataset.values():
            if "bboxes" not in sample:
                continue
            num_with_bboxes += 1
            for label in sample["bbox_labels"]:
                per_label[label] = per_label.get(label, 0) + 1
        lines = [
            "Dataset statistics:--------------",
            f"The total number of samples: {len(self)}",
            f"The total number of classes: {len(per_label)}",
            f"The total number of bboxes: {sum(per_label.values())}",
            f"The total number of neg samples: {len(self) - num_with_bboxes}",
            "For each class:",
        ]
        for label in sorted(per_label):
            lines.append("class {:>3} includes {:>9} bboxes".format(label, per_label[label]))
        return "\n".join(lines) + "\n"
