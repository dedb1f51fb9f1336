"""PLANTED VIOLATIONS — host_sync_in_step.

Host syncs inside step bodies: a CUDA graph cannot capture them, and an
eager step waits for the card once a step.
"""

import functools

import torch
import torch.nn.functional as F

from tpu_syncbn_torch.parallel import scan_driver


class Trainer:
    def _chunk_step(self, chunk, k, batch):
        # a body by name (the trainers' K-step body)
        loss = self.loss(batch)
        scalar = loss.item()  # bad
        labels = F.one_hot(batch.argmax(1))  # bad: reads the index range (C.5)
        return {"loss": loss, "v": scalar, "l": labels}

    def _program_body(self, n):
        def body(k, batch):
            # nested in a builder AND handed to build_scan_steps: one report
            idx = torch.nonzero(batch)  # bad
            rep = batch.repeat_interleave(self.counts)  # bad: tensor repeats
            return {"i": idx, "r": rep}

        return scan_driver.build_scan_steps(
            body, n_steps=n, stacked=False, device=self.device, state=list)

    def _run_scanned(self, batch, chunk):
        out = self.prog(batch)
        # ok: the chunk's one host read, after the replay, in no body
        taken = torch.stack([chunk.taken.double()]).tolist()
        return out, taken


def step(k, batch):
    torch.cuda.synchronize()  # bad
    return {"m": batch.masked_select(batch > 0)}  # bad


def build(n, dev):
    return scan_driver.build_scan_steps(
        functools.partial(step), n_steps=n, stacked=False, device=dev,
        state=list)


def capture(model, static, graph):
    torch.cuda.synchronize()  # ok: the set-up before a capture
    with torch.cuda.graph(graph):
        out = model(static)
        out.cpu()  # bad: inside the captured block
    return out


def graphed(x):
    def inner(y):
        return y.tolist()  # bad

    return torch.cuda.make_graphed_callables((inner,), (x,))
