from rvo3d_tpu_torch.ops.masked_gru import (masked_gru_scan,
                                            masked_gru_scan_cuda,
                                            masked_gru_scan_plain)

__all__ = ["masked_gru_scan", "masked_gru_scan_cuda", "masked_gru_scan_plain"]
