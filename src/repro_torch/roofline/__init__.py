"""Roofline terms of the port's dry run (``launch/dryrun.py``): the
analytic useful work of a cell, and the counts of one rank's program run
eagerly on the meta device."""
