"""The RWKV6 time-mix recurrence: ``ops.wkv6`` and ``ops.wkv6_decode_step``
(the public functions), ``wkv6`` (the binding of ``csrc/wkv6.cu``, with
its ``launches`` counter; the package does not re-export the function
under the module's name) and ``ref`` (the plain version)."""
