from repro_torch.kernels.adc.ops import adc_score_blocks, adc_tables
from repro_torch.kernels.adc.ref import adc_score_blocks_ref, adc_tables_ref

__all__ = ["adc_tables", "adc_score_blocks",
           "adc_tables_ref", "adc_score_blocks_ref"]
