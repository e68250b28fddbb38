from repro_torch.kernels.lstm.ops import lstm_sequence
from repro_torch.kernels.lstm.ref import lstm_sequence_ref

__all__ = ["lstm_sequence", "lstm_sequence_ref"]
