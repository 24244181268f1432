"""EDiffSR: IR-SDE training and restoration with the ConditionalNAFNet (or
ConditionalUNet) denoiser, counterpart of ``fastdiffsr_tpu/ediffsr``
(reference EDiffSR/codes/config/sisr/{train,test}.py). The CLI is
``python -m fastdiffsr_tpu_torch.ediffsr.train -opt <yml> [--test]``."""

from .options import dump_yaml, load_yaml, parse_options

__all__ = ["parse_options", "load_yaml", "dump_yaml"]
