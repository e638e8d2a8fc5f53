"""The algorithm's work per objective call, one module a family: operations
and bytes that stay the same whatever implements them. Each module's
``work(kind, sizes)`` returns (operations, bytes) of one call of ``kind``
("gradient" or "trial") at ``sizes`` (``lib.sizes``)."""
