"""Test harnesses shipped with the package: the deterministic fault
injectors of :mod:`tpu_syncbn_torch.testing.faults`."""
