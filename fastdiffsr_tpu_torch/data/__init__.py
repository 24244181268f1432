from .dataset import LRHRDataset, create_dataset, create_dataloader
from .synth import write_pack

__all__ = ["LRHRDataset", "create_dataset", "create_dataloader",
           "write_pack"]
