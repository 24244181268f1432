from . import library  # noqa: F401  (registers the fdsr:: operators)
from .fused_conv import fused_gn_swish_conv3x3, group_stats_to_norm
from .groupnorm import (channel_stats, gn_swish, gn_swish_custom, gn_swish_dot,
                        gn_swish_reference, gn_swish_stats)
from .quant import quant_conv3
from .tconv import upsample_tconv

__all__ = ["fused_gn_swish_conv3x3", "group_stats_to_norm", "channel_stats",
           "gn_swish", "gn_swish_custom", "gn_swish_dot", "gn_swish_reference",
           "gn_swish_stats", "quant_conv3", "upsample_tconv"]
