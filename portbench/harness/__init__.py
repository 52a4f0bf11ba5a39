"""The benchmark's own machinery: finding cells, configurations, drivers
and metric readers by name, the device checks, and the traced window."""
