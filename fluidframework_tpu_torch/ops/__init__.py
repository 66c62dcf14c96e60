"""The merge plane's tensor layer: segment table, host bridge, the
plain step, the window apply and its Hopper kernel.

Import the submodules directly (``ops.merge_kernel``,
``ops.host_bridge``, ...): this package file imports nothing, so
``convert`` and ``host_bridge`` can depend on each other's modules
without an import cycle.
"""
