"""Plain references of the configurations: plain PyTorch, no kernel of the
system under test, nothing the system has made."""
