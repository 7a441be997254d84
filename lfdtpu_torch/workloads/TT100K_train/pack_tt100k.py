# -*- coding: utf-8 -*-
# Pack TT100K into a pickle dataset with the PyTorch port's data package
# (reference `lfd/data_pipeline/pack/pack_tt100k.py:10-28`, mirroring
# `workloads/TT100K_train/pack_tt100k.py`): the 45-class subset of the json
# annotations, images by path, optional negative images.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch.data import Dataset, TT100KParser  # noqa: E402


def pack(data_root, annotation_json_file_path, id_file_path,
         neg_image_root=None, save_path="./TT100K_pack/tt100k_train.pkl"):
    parser = TT100KParser(
        data_root=data_root,
        annotation_json_file_path=annotation_json_file_path,
        id_file_path=id_file_path,
        neg_image_root=neg_image_root,
    )
    dataset = Dataset(parser=parser, save_path=save_path)
    print(dataset)
    return dataset


if __name__ == "__main__":
    pack(
        data_root="./TT100K/data",
        annotation_json_file_path="./TT100K/data/annotations.json",
        id_file_path="./TT100K/data/train/ids.txt",
    )
