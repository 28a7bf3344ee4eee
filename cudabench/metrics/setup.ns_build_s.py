"""setup.ns_build_s: seconds of the dense inverse stack's build
(`riccati.build_dre_cache_dae_ns`: the Newton-Schulz ladders on the card
and their float64 certification, 8 shifts at config 3's n), on the
harness clock around the call, the device synchronized at its end.
Moves setup_s."""


def read(ctx):
    return ctx.setup.get("ns_build_s")
