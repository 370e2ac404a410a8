"""Input generators: every input of a run drawn from ``--seed`` on the
device. Frozen here, so no change to the port can move them."""
