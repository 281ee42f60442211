"""Host ms a compress call spends in the API entry (api/codec.py), outside
the model entries it calls and the runtime calls that wait for the device."""


def read(trace):
    return trace.api_host_ms("compress")
