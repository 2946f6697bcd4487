from diffpure_tpu_torch.data.datasets import cifar10_subset, imagenet_lmdb_val_subset, \
    imagenet_val_subset, imval_transform, load_data

__all__ = ["cifar10_subset", "imagenet_lmdb_val_subset", "imagenet_val_subset",
           "imval_transform", "load_data"]
