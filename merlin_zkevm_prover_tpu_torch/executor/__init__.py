"""The executor's host pieces: the secondary state machines (``sm/``) and
ECRecover.  The Main SM executor follows in the next slice of the port."""
