"""The benchmark's input generators: frozen copies of the port's own,
drawing on the card from a generator seeded by ``--seed``."""
