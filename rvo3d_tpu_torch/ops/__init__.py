from rvo3d_tpu_torch.ops.masked_gru import (launch_geometry, masked_bigru_scan,
                                            masked_bigru_scan_cuda,
                                            masked_bigru_scan_plain,
                                            masked_gru_scan,
                                            masked_gru_scan_cuda,
                                            masked_gru_scan_plain)

__all__ = ["launch_geometry", "masked_bigru_scan", "masked_bigru_scan_cuda",
           "masked_bigru_scan_plain", "masked_gru_scan", "masked_gru_scan_cuda",
           "masked_gru_scan_plain"]
