"""Observability: the engine watch (plan builds, transfers, device
memory per statement) and the flight recorder (each statement's phases),
behind information_schema's diagnostic tables and /metrics."""
