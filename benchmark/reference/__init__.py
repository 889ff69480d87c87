"""Plain references of the configurations' discrete problems, one module
each, named by a configuration's ``reference.module``."""
