"""Traffic: one generator (``generator.py``) and one data file of
parameters a traffic mix (``<traffic>.json``)."""
