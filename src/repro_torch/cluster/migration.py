"""Migration cost model (paper §4.1 / Fig. 7: time linear in state
bytes), copied from `repro.cluster.migration`."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class MigrationCostModel:
    # linear coefficients (seconds + seconds/GB), Fig. 7 calibration
    suspend_base_s: float = 0.4
    suspend_per_gb_s: float = 2.0
    resume_base_s: float = 0.5
    resume_per_gb_s: float = 2.2
    compress_per_gb_s: float = 3.5
    decompress_per_gb_s: float = 2.5
    compression_ratio: float = 8.0
    transfer_gbps: float = 1.0          # GB/s uncompressed path
    restore_extra_s: float = 0.0        # e.g. compile-cache miss penalty

    def stop_and_copy_time_batch(self, state_gb, transfer_gbps):
        """Compressed stop-and-copy downtime over arrays, in the
        reference's term order (zero bandwidth falls back to
        `transfer_gbps`). The fleet scan repeats this order on device."""
        bw = np.where(transfer_gbps == 0.0, self.transfer_gbps,
                      transfer_gbps)
        t = ((self.suspend_base_s + self.suspend_per_gb_s * state_gb)
             + (self.resume_base_s + self.resume_per_gb_s * state_gb))
        t = t + (self.compress_per_gb_s + self.decompress_per_gb_s) * state_gb
        t = t + (state_gb / self.compression_ratio) / bw
        return t + self.restore_extra_s
