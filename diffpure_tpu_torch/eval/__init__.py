from diffpure_tpu_torch.eval.accuracy import get_accuracy
from diffpure_tpu_torch.eval.defended import DefendedModel, UndefendedModel
from diffpure_tpu_torch.eval.drivers import eval_autoattack, eval_bpda, \
    eval_stadv, robustness_eval
