"""The benchmark's plain reference: plain PyTorch and Python, importing
nothing of the system under test, reading nothing that it made."""
