"""Share of the self-attention calls counted by the window's end that went through
the streaming route's pack pass (ops.attention.fused_self_attention.routes, read by
drivers/offline_batch_ext.py), percent; None where the program has no such counter
or counted no call."""


def read(obs):
    routes = obs.get("attention_routes")
    total = sum(routes.values()) if routes else 0
    if not total:
        return None
    return 100.0 * routes.get("stream_packed", 0) / total
