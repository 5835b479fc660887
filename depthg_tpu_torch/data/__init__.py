from depthg_tpu_torch.data.transforms import (
    get_transform,
    normalize_array,
    unnormalize,
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from depthg_tpu_torch.data.datasets import (
    DirectoryDataset,
    Potsdam,
    PotsdamRaw,
    Coco,
    CityscapesSeg,
    NYUv2,
    PascalVOC,
    CroppedDataset,
    MaterializedDataset,
    create_pascal_label_colormap,
    create_cityscapes_colormap,
)
from depthg_tpu_torch.data.contrastive import ContrastiveSegDataset
from depthg_tpu_torch.data.loader import DataLoader
