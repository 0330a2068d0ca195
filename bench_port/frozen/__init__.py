"""Frozen copies of the yardstick: arithmetic and generators taken from the
repository at commit 3e2a384, kept here so that a later change to the
program cannot move the benchmark that measures it."""
