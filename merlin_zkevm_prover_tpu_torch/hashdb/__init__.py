"""The state DB: the binary SMT over a node store (``smt``, ``database``,
``hashdb``, ``state_manager``) and the bulk-rebuild tree (``hashdb64``)."""
