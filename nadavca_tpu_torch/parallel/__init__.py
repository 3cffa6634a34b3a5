"""Several devices and several processes: ``sharded`` and ``distributed``."""
