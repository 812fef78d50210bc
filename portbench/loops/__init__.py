"""One timed loop a file, named by a traffic mix's ``loop``."""
