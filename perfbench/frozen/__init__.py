"""Frozen copies of what the yardstick needs from the program."""
