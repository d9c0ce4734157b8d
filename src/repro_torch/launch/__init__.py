"""Launchers: serving, training, dry-run planning."""
