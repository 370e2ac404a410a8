"""Plain references: straightforward PyTorch of the same semantics as the
port's timed paths. They import nothing of the port (a test holds this) and
take only the inputs the benchmark itself made."""
