from diffpure_tpu_torch.data.datasets import cifar10_subset, load_data

__all__ = ["cifar10_subset", "load_data"]
