"""JSONL metric logging for the train/serve drivers: the JAX package's
`repro.common.metrics.MetricLogger`, record for record. A tensor value
becomes a float through `.item()`."""

import json
import os
import time


class MetricLogger:
    def __init__(self, path=None, stdout=True):
        self.path = path
        self.stdout = stdout
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step=None, **kv):
        rec = {"t": round(time.time() - self._t0, 4)}
        if step is not None:
            rec["step"] = int(step)
        for k, v in kv.items():
            rec[k] = float(v.item()) if hasattr(v, "item") else v
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        if self.stdout:
            parts = " ".join(f"{k}={v:.5g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in rec.items())
            print(parts, flush=True)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
