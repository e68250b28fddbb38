"""Host->device input pipeline: background-thread prefetch of host
batches onto the device, and the deterministic synthetic LM token
stream (the JAX package's `repro.data.pipeline`)."""

import queue
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_device(x, dev, stream):
    t = torch.as_tensor(np.asarray(x))
    if dev.type != "cuda":
        return t.to(dev)
    with torch.cuda.stream(stream):
        out = t.pin_memory().to(dev, non_blocking=True)
    return out


class Prefetcher:
    """Wrap a host batch iterator (dicts of numpy arrays); a background
    thread copies each batch to `device` (None: the card) while the
    consumer computes, `depth` batches ahead. On the card the copies run
    from pinned memory on a side stream, and `next` makes the consumer's
    current stream wait for the batch's copy before handing it over."""

    def __init__(self, it, device=None, depth=2):
        self.it = it
        self.device = resolve_device(device)
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.q = queue.Queue(maxsize=depth)
        self._done = object()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for batch in self.it:
                out = {k: _to_device(v, self.device, self.stream)
                       for k, v in batch.items()}
                event = None
                if self.stream is not None:
                    event = torch.cuda.Event()
                    event.record(self.stream)
                self.q.put((out, event))
        finally:
            self.q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._done:
            raise StopIteration
        batch, event = item
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
            for t in batch.values():
                t.record_stream(torch.cuda.current_stream(self.device))
        return batch


def lm_synthetic_batches(vocab, batch, seq, steps, seed=0):
    """Deterministic synthetic LM token stream (ngram-ish structure so the
    loss actually falls): next token = (3*tok + noise) % vocab. The same
    numpy generator calls as the JAX package's, so the same batches."""
    rng = np.random.default_rng(seed)
    for step in range(steps):
        first = rng.integers(0, vocab, (batch, 1))
        toks = [first]
        for _ in range(seq):
            nxt = (3 * toks[-1] + rng.integers(0, 7, (batch, 1))) % vocab
            toks.append(nxt)
        arr = np.concatenate(toks, axis=1).astype(np.int32)
        yield {"tokens": arr[:, :seq], "labels": arr[:, 1:seq + 1]}
