"""Planted-violation fixtures for the port's source-lint rules
(``tpu_syncbn_torch.audit.srclint``).

Each ``bad_<rule>.py`` here holds code that MUST trigger its rule;
``tests/test_torch_audit_srclint.py`` lints every fixture and asserts the
rule fires (a rule with no firing fixture is dead weight). ``clean.py``
holds near-miss code that must NOT fire anything. The fixtures are never
imported or executed; they only need to parse.
"""
