"""MoE layer: router, dispatch/combine, expert FFN."""
