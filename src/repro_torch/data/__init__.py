"""Host-side data helpers of the port (numpy): the synthetic LM data,
the modality stubs' inputs and the move of a batch to a device."""
