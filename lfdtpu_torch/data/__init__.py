from .augmentation import (
    BGR2RGB,
    Compose,
    HorizontalFlip,
    Normalize,
    caffe_imagenet_normalize,
    simple_normalize,
    simple_widerface_train_pipeline,
    simple_widerface_val_pipeline,
    standard_normalize,
    typical_coco_train_pipeline,
    typical_coco_val_pipeline,
)
from .dataset import Dataset
from .dataset_samplers import (
    BaseDatasetSampler,
    COCORandomDatasetSampler,
    RandomDatasetSampler,
    RandomWithNegDatasetSampler,
    ShardedDatasetSampler,
)
from .device_aug import AUG_KEYS, DeviceAugment, DeviceAugRegionSampler, make_device_augment
from .jpeg import crop as jpeg_crop, decode as jpeg_decode, encode as jpeg_encode, scale_with_quality
from .loader import DataLoader, ShmDataLoader, pad_annotations
from .pack import check_by_show, pack_coco, pack_mini_for_debug, pack_tt100k, pack_widerface
from .parsers import TT100K_TYPE45, COCOParser, Parser, TT100KParser, WIDERFACEParser
from .region_samplers import (
    BaseRegionSampler,
    IdleRegionSampler,
    RandomBBoxCropRegionSampler,
    RandomBBoxCropWithRangeSelectionRegionSampler,
    TypicalCOCOTrainingRegionSampler,
    crop_from_image,
)
from .resize import resize_linear
from .sample import Sample, reserved_keys

__all__ = [
    "Sample", "reserved_keys",
    "Parser", "WIDERFACEParser", "COCOParser", "TT100KParser", "TT100K_TYPE45",
    "Dataset",
    "BaseDatasetSampler", "RandomDatasetSampler", "COCORandomDatasetSampler",
    "RandomWithNegDatasetSampler", "ShardedDatasetSampler",
    "BaseRegionSampler", "TypicalCOCOTrainingRegionSampler",
    "RandomBBoxCropRegionSampler", "RandomBBoxCropWithRangeSelectionRegionSampler",
    "IdleRegionSampler", "crop_from_image", "resize_linear",
    "Compose", "HorizontalFlip", "Normalize", "BGR2RGB",
    "caffe_imagenet_normalize", "standard_normalize", "simple_normalize",
    "simple_widerface_train_pipeline", "simple_widerface_val_pipeline",
    "typical_coco_train_pipeline", "typical_coco_val_pipeline",
    "AUG_KEYS", "DeviceAugRegionSampler", "DeviceAugment", "make_device_augment",
    "DataLoader", "ShmDataLoader", "pad_annotations",
    "jpeg_decode", "jpeg_encode", "scale_with_quality", "jpeg_crop",
    "pack_widerface", "pack_coco", "pack_tt100k", "pack_mini_for_debug", "check_by_show",
]
