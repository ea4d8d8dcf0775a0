"""FLOP, parameter, throughput and receptive-field tools (counterpart of
bem_tpu/analysis; its ``plot.py`` needs matplotlib and is not ported)."""

from .erf import effective_receptive_field, erf_high_contribution_ratio
from .flops_param import (analyze_network, count_flops, count_params, flops_selective_scan,
                          throughput)

__all__ = ["analyze_network", "count_flops", "count_params", "effective_receptive_field",
           "erf_high_contribution_ratio", "flops_selective_scan", "throughput"]
