from diffpure_tpu_torch.eval.accuracy import get_accuracy
from diffpure_tpu_torch.eval.defended import DefendedModel
