"""Measurement scripts for the card (each run with ``python -m``)."""
import subprocess


def card_line():
    """The card's name and power limit as ``nvidia-smi`` gives them, or why
    there is none."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        return "no nvidia-smi (%s)" % e
