"""Package version, recorded in every run-ledger header so archived
experiment streams stay attributable to the code that produced them
(``repro_torch.telemetry.ledger``). The port's own copy of
``repro.version``; bump on ledger-schema-affecting changes."""
__version__ = "0.10.0"
