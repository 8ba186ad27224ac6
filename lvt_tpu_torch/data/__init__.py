from .build import build_train_loader, collate, get_dataset_dicts
from .catalog import DatasetCatalog, MetadataCatalog
from .mapper import DatasetMapper

from .datasets import builtin  # noqa: F401  (registers the latent datasets)

__all__ = ["DatasetCatalog", "DatasetMapper", "MetadataCatalog", "build_train_loader",
           "collate", "get_dataset_dicts"]
