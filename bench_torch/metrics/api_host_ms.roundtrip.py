"""Host ms a round trip (compress and decompress) spends in the API entry
(api/codec.py), outside the model entries and the runtime calls that wait."""


def read(trace):
    return trace.api_host_ms("roundtrip")
