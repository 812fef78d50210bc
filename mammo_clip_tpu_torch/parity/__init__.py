"""Quality-parity tooling of the port: a fake of the public ``.tar`` contract
and the one-command parity runner (ports of the repository's ``parity/``)."""
