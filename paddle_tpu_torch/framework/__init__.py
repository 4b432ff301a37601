"""The framework core of the port. So far the operator registry
(``framework.registry``: ``register_op``, ``get_op_info`` and
``run_op``, one op run as the JAX ``Executor`` runs it); the Program,
the Executor and the layers DSL are later slices (ROADMAP A1-A3)."""
