# -*- coding: utf-8 -*-
# Pack the WIDERFACE train set into a pickle dataset with the PyTorch
# port's data package (reference `WIDERFACE_train/pack_widerface.py:9-39`,
# mirroring `workloads/WIDERFACE_train/pack_widerface.py`): the parser walks
# the txt annotations and embeds the image bytes; check_dataset() draws the
# packed boxes for visual inspection.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch.data import Dataset, WIDERFACEParser  # noqa: E402


def pack(annotation_file_path, image_root, neg_image_root=None,
         save_path="./WIDERFACE_pack/widerface_train.pkl"):
    parser = WIDERFACEParser(
        annotation_file_path=annotation_file_path,
        image_root=image_root,
        neg_image_root=neg_image_root,
    )
    dataset = Dataset(parser=parser, save_path=save_path)
    print(dataset)
    return dataset


def check_dataset(dataset_path, num=10, out_dir="."):
    """Visual inspection: draw packed boxes (`pack_widerface.py:19-39`)."""
    import cv2

    from lfdtpu_torch.data.jpeg import decode

    dataset = Dataset(load_path=dataset_path)
    for i, index in enumerate(dataset.get_indexes()[:num]):
        sample = dataset[index]
        image = decode(sample["image_bytes"])
        for bbox in sample.get("bboxes", []):
            cv2.rectangle(
                image,
                (int(bbox[0]), int(bbox[1])),
                (int(bbox[0] + bbox[2]), int(bbox[1] + bbox[3])),
                (0, 255, 0), 1,
            )
        out = os.path.join(out_dir, f"widerface_check_{i}.jpg")
        cv2.imwrite(out, image)
        print(f"wrote {out}")


if __name__ == "__main__":
    pack(
        annotation_file_path="./WIDER_train/wider_face_train_bbx_gt.txt",
        image_root="./WIDER_train/images",
        neg_image_root=None,
    )
