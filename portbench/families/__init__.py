"""The program's side of each model family: ``<family>.py`` maps a
configuration onto the port's model config (``program_config(config,
spec)``).  Kept apart from ``reference/`` so that the plain reference
imports nothing of the program under test."""
